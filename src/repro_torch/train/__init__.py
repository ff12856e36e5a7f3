"""Training substrate: train step, optimizers, checkpointing, supervision.

Submodules (imported explicitly, as the reference's):

  optimizer    AdamW, Adafactor, global-norm clipping, the cosine schedule
  train_step   make_train_step: loss -> grads (microbatches) -> optimizer
  checkpoint   atomic checkpoints in the reference's format
  fault        run_supervised: checkpoint/restart and straggler accounting
"""
