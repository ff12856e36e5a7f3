"""Port's index substrate == the reference's, array for array.

Both packages build the synthetic discogs corpus from the same seeds; the
tree, containment, DAG and redundancy-component arrays, the per-RC IDLists
and the scalar algorithms' answers must be equal.  Index artifacts written
by either package load in the other and serve equal answers, and
``parts_from_arrays`` takes the very arrays dict the reference saves.
"""
import json
import os

import numpy as np
import pytest

from repro.core import KeywordSearchEngine as RefEngine
from repro.core import io as ref_io
from repro.core import search_base as ref_search_base
from repro.core.components import build_indices as ref_build_indices
from repro.data import QUERIES
from repro.data import generate_discogs_tree as ref_generate
from repro_torch.core import KeywordSearchEngine
from repro_torch.core import io as port_io
from repro_torch.core import search_base
from repro_torch.core.components import IDClusterIndex, build_indices
from repro_torch.core.idlist import BaseIndex
from repro_torch.data import generate_discogs_tree

WORDS = [kws for _, kws in QUERIES.values()]


def build_both(seed: int, n_releases: int = 40):
    ref_tree = ref_generate(n_releases=n_releases, seed=seed)
    tree = generate_discogs_tree(n_releases=n_releases, seed=seed)
    return (ref_tree, *ref_build_indices(ref_tree)), (tree, *build_indices(tree))


@pytest.fixture(scope="module", params=[0, 1], ids=["seed0", "seed1"])
def built(request):
    return build_both(request.param)


def test_tree_arrays_equal(built):
    (rt, _, _), (pt, _, _) = built
    for name in ("parent", "subtree_size", "kw_offsets", "kw_ids"):
        np.testing.assert_array_equal(getattr(pt, name), getattr(rt, name), name)
    assert pt.vocab.id_to_word == rt.vocab.id_to_word


def test_containment_dag_and_rc_arrays_equal(built):
    (_, rb, rc), (_, pb, pc) = built
    for name in ("kws", "nodes", "counts", "kw_starts"):
        np.testing.assert_array_equal(
            getattr(pb.containment, name), getattr(rb.containment, name), name
        )
    np.testing.assert_array_equal(pc.dag.canon, rc.dag.canon)
    np.testing.assert_array_equal(pc.dag.occ, rc.dag.occ)
    assert pc.dag.num_canonical == rc.dag.num_canonical
    assert pc.rcs.num_rcs == rc.rcs.num_rcs
    for name in (
        "rc_of_node", "rc_root", "rc_occ", "dummy_ids", "dummy_parent_rc",
        "dummy_nested_rc", "dummy_offset",
    ):
        np.testing.assert_array_equal(getattr(pc.rcs, name), getattr(rc.rcs, name), name)
    assert pc.rcs.rc_children == rc.rcs.rc_children


def test_per_rc_idlists_equal(built):
    (rt, _, rc), (_, _, pc) = built
    kws = sorted({rt.vocab.get(w) for ws in WORDS for w in ws})
    for r in range(rc.num_rcs):
        for kw in kws:
            want, got = rc.idlist(r, kw), pc.idlist(r, kw)
            for name in ("ids", "pidpos", "ndesc"):
                np.testing.assert_array_equal(
                    getattr(got, name), getattr(want, name), f"rc={r} kw={kw} {name}"
                )


def test_scalar_algorithms_equal(built):
    (rt, rb, rc), (_, pb, pc) = built
    assert sorted(search_base.BASE_ALGORITHMS) == sorted(ref_search_base.BASE_ALGORITHMS)
    for words in WORDS:
        kws = [rt.vocab.get(w) for w in words]
        for algo, fn in search_base.BASE_ALGORITHMS.items():
            ref_fn = ref_search_base.BASE_ALGORITHMS[algo]
            np.testing.assert_array_equal(
                fn(pb.idlists(kws)), ref_fn(rb.idlists(kws)), f"{words} {algo}"
            )
            np.testing.assert_array_equal(
                search_base.dag_search(pc, kws, algorithm=algo),
                ref_search_base.dag_search(rc, kws, algorithm=algo),
                f"{words} dag {algo}",
            )


def _answers(engine, backend):
    return [
        engine.query(words, semantics=sem, index=index, backend=backend)
        for words in WORDS
        for sem in ("slca", "elca")
        for index in ("tree", "dag")
    ]


def _assert_answers_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def ref_engine():
    return RefEngine(ref_generate(n_releases=40, seed=2))


def test_parts_from_arrays_serves_reference_arrays(ref_engine, tmp_path):
    # the arrays dict the reference's save_parts writes, read back raw
    ref_engine.save(str(tmp_path))
    with open(tmp_path / "manifest.json") as f:
        manifest = json.load(f)
    with np.load(os.path.join(tmp_path, manifest["arrays_file"])) as z:
        arrays = {name: z[name] for name in z.files}
    tree, containment, dag, rcs, _ = port_io.parts_from_arrays(arrays, manifest)
    engine = KeywordSearchEngine(
        tree,
        base=BaseIndex(tree, containment),
        cluster=IDClusterIndex(tree, containment, dag=dag, rcs=rcs),
        device="cpu",
    )
    _assert_answers_equal(_answers(engine, "fused"), _answers(ref_engine, "scalar"))


def test_artifacts_cross_load(ref_engine, tmp_path):
    ref_engine.save(str(tmp_path / "ref"))
    port = KeywordSearchEngine.load(str(tmp_path / "ref"), device="cpu")
    want = _answers(ref_engine, "scalar")
    _assert_answers_equal(_answers(port, "scalar"), want)
    _assert_answers_equal(_answers(port, "torch"), want)
    port.save(str(tmp_path / "port"))
    back = RefEngine.load(str(tmp_path / "port"))
    _assert_answers_equal(_answers(back, "scalar"), want)
    assert port_io.FORMAT_VERSION == ref_io.FORMAT_VERSION
    assert port_io.load_manifest(str(tmp_path / "ref")) == ref_io.load_manifest(
        str(tmp_path / "ref")
    )
