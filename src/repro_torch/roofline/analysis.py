"""Roofline terms on the H100: the card's peaks, a traced step's roofline and a search round's global-memory accesses.

``HW`` holds the peaks of one NVIDIA H100 SXM from NVIDIA's data sheet
(dense rates, no sparsity, at the full 700 W power limit).  They are
published peaks, not measurements; a card set below 700 W runs slower under
load.

``search_pipeline_bytes`` counts the global-memory accesses, in bytes, of
one batched search round on the port's two device routes, for the
``kernel.fused_round`` span (``core/plan_cache.py``): the fused kernel
(``csrc/fused_search.cu``) on the route ``kernels/fused_search.py::route``
picks, and the port's chained kernels (``csrc/searchsorted.cu`` per other
list, the compaction, the keep rule and ``csrc/elca_segsum.cu``) for the
same rows.  An access counts whether the L2 cache or HBM serves it, so the
count is not the DRAM traffic and its time at the HBM rate is not a lower
bound on the round.

Per (arch × shape × mesh), from the dry-run's trace (``launch/dryrun.py``;
all per device):
  compute    = traced FLOPs / HW["peak_flops"]        [bf16 dense peak]
  memory     = traced bytes / HW["hbm_bw"]            [HBM3]
  collective = collective bytes / link_bw(chips)      [the link the mesh crosses]

The reference parsed its FLOPs, bytes and collectives out of compiled HLO
text; the port produces no HLO, so that role passed to the trace: FLOPs,
bytes (each op's input and output bytes, the proxy for XLA's ``bytes
accessed``) and each collective's result bytes come from
``roofline/profile.py::TraceCounter``, and :func:`collective_bytes_from_trace`
reads the collective bytes by kind.  ``link_bw``: a mesh of at most 8 ranks
fits one HGX/DGX H100 node, NVLink; a larger mesh (both production meshes)
crosses nodes, one 400 Gb/s ConnectX-7 NIC per GPU.

MODEL_FLOPS = 6·N·D (dense) or 6·N_active·D (MoE), 2·N·D outside training;
the ratio MODEL_FLOPS / traced FLOPs exposes remat and redundant work.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass

from repro_torch.kernels import fused_search

HW = {
    # dense bf16 tensor-core FLOP/s, H100 SXM (NVIDIA H100 data sheet)
    "peak_flops": 989e12,
    # HBM3 bytes/s, H100 SXM (NVIDIA H100 data sheet)
    "hbm_bw": 3.35e12,
    # NVLink 4 bytes/s per direction (900 GB/s both ways), H100 SXM (NVIDIA
    # H100 data sheet)
    "nvlink_bw": 450e9,
    # bytes/s a GPU sends across nodes: one 400 Gb/s ConnectX-7 per GPU
    # (NVIDIA DGX H100 data sheet)
    "net_bw": 50e9,
}
NODE_GPUS = 8  # GPUs of one HGX/DGX H100 node, all to all over NVLink
COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")


def link_bw(chips: int) -> float:
    """Bytes/s of the link a mesh of ``chips`` ranks crosses: NVLink within
    one node, the network beyond it."""
    return HW["nvlink_bw"] if chips <= NODE_GPUS else HW["net_bw"]


def collective_bytes_from_trace(counter) -> dict[str, int]:
    """Result bytes of every collective one device issued in a traced step
    (``profile.TraceCounter``), keyed by kind, plus ``total``."""
    out = {k: int(counter.collectives[k]) for k in COLLECTIVES}
    out["total"] = sum(out[k] for k in COLLECTIVES)
    return out


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    traced_flops: float
    traced_bytes: float
    collective_bytes: float
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float
    useful_ratio: float  # MODEL_FLOPS / (chips × traced FLOPs)
    step_time_bound_s: float
    hw_fraction: float  # compute_s / step_time_bound_s ("roofline fraction")
    note: str = ""

    def to_dict(self):
        return asdict(self)


def analyze(
    *,
    arch: str,
    shape: str,
    mesh_name: str,
    chips: int,
    cost: dict,
    model_flops: float,
    note: str = "",
) -> RooflineReport:
    """The roofline of one cell from its per-device ``cost`` (``flops``,
    ``bytes``, ``collective_bytes``: a trace's or the accounting's)."""
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes", 0.0))
    coll = float(cost.get("collective_bytes", 0.0))
    compute_s = flops / HW["peak_flops"]
    memory_s = byts / HW["hbm_bw"]
    collective_s = coll / link_bw(chips)
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    bound = max(terms.values())
    return RooflineReport(
        arch=arch,
        shape=shape,
        mesh=mesh_name,
        chips=chips,
        traced_flops=flops,
        traced_bytes=byts,
        collective_bytes=coll,
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        bottleneck=bottleneck,
        model_flops=model_flops,
        useful_ratio=(model_flops / chips) / flops if flops else 0.0,
        step_time_bound_s=bound,
        hw_fraction=compute_s / bound if bound else 0.0,
        note=note,
    )


def model_flops_for(cfg, shape_cell, train: bool) -> float:
    """6·N·D per step (3x for fwd+bwd via the standard 6ND convention)."""
    n_active = cfg.active_param_count()
    tokens = shape_cell.global_batch * (
        shape_cell.seq_len if shape_cell.kind == "train" else
        (shape_cell.seq_len if shape_cell.kind == "prefill" else 1)
    )
    mult = 6.0 if shape_cell.kind == "train" else 2.0
    return mult * n_active * tokens

_I32 = 4  # ids, parents, NDesc, positions, counts and sums are int32
_U8 = 1  # keep_mask and the found masks are a byte a slot
_STAGE = fused_search._STAGE_INTS  # search.cuh kStage: ids a staging buffer holds
_TILE = 256  # search.cuh kThreads: L0 slots a block of the fused tiles route
_SS_TILE = 512  # searchsorted.cu kTile: queries a block of the searchsorted kernel


def staged_ids(w: int) -> int:
    """Ids ``search.cuh::staged_of`` stages for a window of ``w`` ids: all of
    them up to kStage - 3, else one every ``step`` ids."""
    if w <= _STAGE - 3:
        return w
    step = max(2, -(-w // _STAGE))
    return -(-w // step)


def fused_staging(m0: int, k: int, mo: int, semantics: str) -> dict:
    """What the fused kernel stages for rows of ``m0`` L0 slots and ``k - 1``
    other lists of ``mo`` ids: its ``route``; ``window``, the staged windows
    of each other list a row takes (one per tile of L0: of
    ``row_threads(m0)`` slots on the rows route, of 256 on the tiles route);
    ``bo``, the ids one window holds at most (a staging buffer, kStage, or
    the whole list when shorter); ``nob``, the list's blocks of ``bo`` ids."""
    which = fused_search.route(m0, k, semantics)
    tile = fused_search.row_threads(m0) if which == "rows" else _TILE
    bo = min(_STAGE, mo)
    return {"route": which, "window": -(-m0 // tile), "bo": bo, "nob": -(-mo // bo)}


@dataclass
class SearchBytesModel:
    """Global-memory accesses (bytes) of one batched search round, chained vs
    fused.

    Counted from the shapes alone, at their most: every L0 slot valid and a
    CA with its parent among the CAs, every other list as long as its
    bucket.  Each load or store a kernel makes of an array element counts
    once per pass that makes it (so a pass that reads a plane again counts
    it again), at 4 bytes an int32 and 1 a mask byte; the O(log) probes of
    the window searches (``warp_bound``, and the segment a sampled window
    leaves to global memory) are not counted.

    ``route``, ``window``, ``bo`` and ``nob`` are what the fused kernel
    stages for this shape (:func:`fused_staging`); ``window`` and ``bo``
    bound what it stages of one other list for a row: ``min(window * bo,
    mo)`` ids, since the windows of a row's ascending tiles do not overlap
    and each stages at most ``bo`` ids.

    fused, rows route (one launch, the row's state in shared memory):
      stream: n0 and other_n, L0's ids once, the staged windows, the parent
        ids (SLCA/ELCA), the other lists' NDesc at each match and L0's NDesc
        for the parent sums (ELCA);
      finalize: keep_ids and keep_mask written, L0's NDesc read again (ELCA).
    fused, tiles route (three launches over tiles of 256, state in scratch
    planes):
      stream: the membership pass (n0 and other_n per block, each slot's L0
        id once per other list, the staged windows, the NDesc at each match
        (ELCA); L0 staged by every block of its row and the parent ids (SLCA
        and ELCA); the CA, count, position, NDesc and sum planes written)
        and the parent pass (the CA and position planes, the parent's CA
        flag, the NDesc (ELCA), one atomic read-modify-write per parent
        count or sum);
      finalize: the keep pass (CA plane, L0 ids, the count or the NDesc and
        sums) and keep_ids and keep_mask written.
    chained (the port's chained kernels for the same rows):
      membership: per other list one searchsorted call (L0's ids read, the
        list staged, a tile of 512 queries a block, whole up to 4,093 ids;
        positions written) and the found test and NDesc gather at those
        positions (found and NDesc written);
      compact: the CA mask from the found masks, then the CAs' ids, parent
        ids (SLCA/ELCA) and k NDesc rows (ELCA) copied out;
      segsum: the keep step: ELCA, ``elca_segsum`` (CAs, parents, k NDesc
        rows read; k sums written) and the keep rule; SLCA, the shift
        compare of each CA with the next one's parent; CA, nothing.

    ``*_bw_ms`` are the bytes over ``HW["hbm_bw"]``: the accesses' time if
    HBM served every one of them.  Re-reads that the 50 MB L2 serves (the
    tiles route's L0, restaged by every block of a row) cost less, so this
    is neither a lower bound on the round nor a time it was measured to
    take.
    """

    rows: int
    k: int
    m0: int
    mo: int
    route: str
    window: int
    bo: int
    nob: int
    # chained per-phase attribution
    chained_membership_bytes: int
    chained_compact_bytes: int
    chained_segsum_bytes: int
    chained_bytes: int
    # fused per-phase attribution
    fused_stream_bytes: int
    fused_finalize_bytes: int
    fused_bytes: int
    chained_bw_ms: float
    fused_bw_ms: float
    bytes_ratio: float  # chained / fused (>1 == fusion moves fewer bytes)

    def attrs(self) -> dict:
        """Flat span-attribute dict (the fused round's cost attribution)."""
        return asdict(self)


def _fused_rows(k1: int, m0: int, streamed: int, semantics: str) -> tuple[int, int]:
    """(stream, finalize) bytes of one row on the fused rows route."""
    stream = _I32 * (1 + k1 + m0 + k1 * streamed)
    finalize = _I32 * m0 + _U8 * m0
    if semantics == "slca":
        stream += _I32 * m0
    elif semantics == "elca":
        stream += _I32 * (m0 + k1 * m0 + m0)
        finalize += _I32 * m0
    return stream, finalize


def _fused_tiles(k1: int, m0: int, streamed: int, window: int,
                 semantics: str) -> tuple[int, int]:
    """(stream, finalize) bytes of one row on the fused tiles route."""
    k = k1 + 1
    member = _I32 * (window * (1 + k1) + k1 * m0 + k1 * streamed + 2 * m0)
    parent = 0
    finalize = _I32 * 2 * m0 + _I32 * m0 + _U8 * m0
    if semantics != "ca":
        member += _I32 * (window * staged_ids(m0) + m0 + m0)
        parent = _I32 * 3 * m0
    if semantics == "slca":
        parent += 2 * _I32 * m0
        finalize += _I32 * m0
    elif semantics == "elca":
        member += _I32 * (k * m0 + k1 * m0 + k1 * m0)
        parent += _I32 * (m0 + k1 * m0) + 2 * _I32 * k * m0
        finalize += _I32 * (m0 + k * m0 + k1 * m0)
    return member + parent, finalize


def _chained(k1: int, m0: int, mo: int, semantics: str) -> tuple[int, int, int]:
    """(membership, compact, segsum) bytes of one row on the chained kernels."""
    k = k1 + 1
    tiles = -(-m0 // _SS_TILE)
    staged = tiles * mo if mo <= _STAGE - 3 else min(tiles * _STAGE, mo)
    membership = k1 * (_I32 * (m0 + m0 + 2 * m0 + m0) + _I32 * staged + _U8 * m0)
    copied = {"slca": 2, "elca": 2 + k, "ca": 1}[semantics] * m0
    compact = _U8 * (k1 * m0 + m0 + m0) + _I32 * 2 * copied
    if semantics == "elca":
        segsum = _I32 * ((2 + k) * m0 + k * m0) + _I32 * ((2 * k + 1) * m0 + m0) + _U8 * m0
    elif semantics == "slca":
        segsum = _I32 * (2 * m0 + m0) + _U8 * m0
    else:
        segsum = 0
    return membership, compact, segsum


def search_pipeline_bytes(
    *, rows: int, k: int, m0: int, mo: int, semantics: str = "slca",
) -> SearchBytesModel:
    """Bytes model for one batched (R, k, m0, mo) search round, with what the
    fused kernel stages on its route for this shape and ``semantics``
    (:func:`fused_staging`)."""
    staging = fused_staging(m0, k, mo, semantics)
    window, bo = staging["window"], staging["bo"]
    k1 = max(k - 1, 0)
    streamed = min(window * bo, mo)
    if staging["route"] == "rows":
        stream, finalize = _fused_rows(k1, m0, streamed, semantics)
    else:
        stream, finalize = _fused_tiles(k1, m0, streamed, window, semantics)
    membership, compact, segsum = _chained(k1, m0, mo, semantics)
    stream, finalize = rows * stream, rows * finalize
    membership, compact, segsum = rows * membership, rows * compact, rows * segsum
    chained = membership + compact + segsum
    fused = stream + finalize
    return SearchBytesModel(
        rows=rows, k=k, m0=m0, mo=mo, **staging,
        chained_membership_bytes=membership,
        chained_compact_bytes=compact,
        chained_segsum_bytes=segsum,
        chained_bytes=chained,
        fused_stream_bytes=stream,
        fused_finalize_bytes=finalize,
        fused_bytes=fused,
        chained_bw_ms=chained / HW["hbm_bw"] * 1e3,
        fused_bw_ms=fused / HW["hbm_bw"] * 1e3,
        bytes_ratio=chained / fused if fused else 0.0,
    )
