"""The beam-search step and the backtrack decode (ops/beam_search_ops.py)
against the JAX package.

Counterparts of the 4 tests of tests/test_beam_search.py: each runs the
same program in both packages on the same inputs and holds the port to
the JAX test's expectations and to the JAX package's outputs (ids and
parents equal, scores within rtol 1e-6, fp32). Added: forced ties, where
`lax.top_k` puts the lower index first and the port's stable sort must
too, held bitwise to the JAX op; and `cuda`-marked twins (skipped
without a card) that hold the op on the card bitwise to the host.
"""

import itertools

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.core import framework as tframework
from paddle_tpu_torch.core import scope as tscope

SCORE_RTOL = 1e-6


@pytest.fixture(autouse=True)
def _fresh_port_state():
    torch.set_num_threads(2)
    tframework.switch_main_program(tframework.Program())
    tframework.switch_startup_program(tframework.Program())
    tscope.reset_global_scope()
    tfluid.unique_name.switch()
    yield


def _beam_step(fluid, place, pre_ids, ids, scores, beam_size, end_id,
               pre_scores=None):
    with fluid.program_guard(fluid.Program(), fluid.Program()):
        pi = fluid.layers.data(name="pi", shape=[1], dtype="int64")
        feed = {"pi": pre_ids, "sc": scores}
        idv = None
        if ids is not None:
            idv = fluid.layers.data(name="ids", shape=[ids.shape[1]],
                                    dtype="int64")
            feed["ids"] = ids
        sc = fluid.layers.data(name="sc", shape=[scores.shape[1]],
                               dtype="float32")
        ps = None
        if pre_scores is not None:
            ps = fluid.layers.data(name="ps", shape=[1], dtype="float32")
            feed["ps"] = pre_scores
        fetch = fluid.layers.beam_search(pi, idv, sc, beam_size, end_id,
                                         pre_scores=ps, return_parents=True)
        outs = fluid.Executor(place).run(feed=feed, fetch_list=list(fetch))
        return [np.asarray(o) for o in outs]


def run_step(*args, **kw):
    """The step in both packages: the port's (ids, scores, parents),
    checked against the JAX package's."""
    want = _beam_step(jfluid, jfluid.CPUPlace(), *args, **kw)
    got = _beam_step(tfluid, tfluid.CPUPlace(), *args, **kw)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=SCORE_RTOL)
    np.testing.assert_array_equal(got[2], want[2])
    return got


def test_beam_search_basic_selection():
    """2 sources x 2 beams x 3 candidates: top-2 per source."""
    pre_ids = np.array([[1], [2], [3], [4]], dtype="int64")
    ids = np.arange(12, dtype="int64").reshape(4, 3) + 10
    scores = np.array([[0.5, 0.9, 0.1], [0.8, 0.2, 0.3],
                       [0.1, 0.2, 0.3], [0.4, 0.5, 0.6]], dtype="float32")
    si, ss, par = run_step(pre_ids, ids, scores, 2, end_id=99)
    assert si[:2, 0].tolist() == [11, 13]
    np.testing.assert_allclose(ss[:2, 0], [0.9, 0.8])
    assert par[:2, 0].tolist() == [0, 1]
    assert si[2:, 0].tolist() == [21, 20]
    assert par[2:, 0].tolist() == [3, 3]


def test_beam_search_finished_and_inactive():
    """A finished beam carries (end_id, pre_score); an inactive slot
    contributes nothing."""
    end = 7
    pre_ids = np.array([[end], [3], [5], [-1]], dtype="int64")
    pre_scores = np.array([[2.0], [0.0], [0.0], [0.0]], dtype="float32")
    ids = np.full((4, 2), 4, dtype="int64")
    scores = np.array([[9.0, 9.0], [0.5, 0.1], [0.3, 0.4], [8.0, 8.0]],
                      dtype="float32")
    si, ss, par = run_step(pre_ids, ids, scores, 2, end,
                           pre_scores=pre_scores)
    assert si[0, 0] == end and abs(ss[0, 0] - 2.0) < 1e-6
    assert si[1, 0] == 4 and abs(ss[1, 0] - 0.5) < 1e-6
    assert par[0, 0] == 0 and par[1, 0] == 1
    assert par[2:, 0].tolist() == [2, 2]


def _ties():
    """Scores with ties among live candidates, finished beams whose
    NEG_INF columns tie in bulk, and inactive slots; no ids (the
    whole-vocabulary case)."""
    rs = np.random.RandomState(11)
    K, B, C = 4, 3, 6
    scores = rs.randint(-3, 1, (B * K, C)).astype("float32")
    pre_ids = rs.randint(2, 9, (B * K, 1)).astype("int64")
    pre_ids[1, 0] = pre_ids[6, 0] = pre_ids[8, 0] = 1  # finished
    pre_ids[3, 0] = pre_ids[9:, 0] = -1                 # inactive
    pre_scores = rs.randint(-2, 1, (B * K, 1)).astype("float32")
    return pre_ids, scores, pre_scores, K


def test_beam_search_forced_ties_bitwise():
    """Equal scores everywhere: the port picks what `lax.top_k` picks,
    lower flat index first, bitwise."""
    pre_ids, scores, pre_scores, K = _ties()
    want = _beam_step(jfluid, jfluid.CPUPlace(), pre_ids, None, scores, K,
                      1, pre_scores=pre_scores)
    got = _beam_step(tfluid, tfluid.CPUPlace(), pre_ids, None, scores, K,
                     1, pre_scores=pre_scores)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.astype(g.dtype))
    # source 2 holds one finished beam (row 8) and 3 inactive rows: one
    # real candidate, then NEG_INF ties taken in index order (row 8's)
    np.testing.assert_array_equal(got[1][9:, 0], [-1e9] * 3)
    assert got[2][8:, 0].tolist() == [8] * 4


def test_beam_search_decode_backtrack():
    """A hand-built 3-step history with known parents."""
    ids = np.array([[[5], [6]], [[7], [8]], [[9], [2]]], dtype="int64")
    parents = np.array([[[0], [1]], [[1], [0]], [[0], [0]]], dtype="int64")
    scores = np.arange(6, dtype="float32").reshape(3, 2, 1)
    outs = {}
    for name, fluid in (("jax", jfluid), ("port", tfluid)):
        with fluid.program_guard(fluid.Program(), fluid.Program()):
            iv = fluid.layers.data(name="ids", shape=[2, 1], dtype="int64")
            sv = fluid.layers.data(name="sc", shape=[2, 1], dtype="float32")
            pv = fluid.layers.data(name="par", shape=[2, 1], dtype="int64")
            fetch = fluid.layers.beam_search_decode(iv, sv, parents=pv,
                                                    end_id=2)
            kw = {"return_numpy": False} if name == "jax" else {}
            outs[name] = fluid.Executor(fluid.CPUPlace()).run(
                feed={"ids": ids, "sc": scores, "par": parents},
                fetch_list=list(fetch), **kw)
    ids_lt, sc_lt = outs["port"]
    assert ids_lt.lod() == [[0, 3, 6]]
    data = np.asarray(ids_lt.numpy()).reshape(-1)
    assert data[:3].tolist() == [6, 7, 9]
    assert data[3:6].tolist() == [6, 7, 2]
    for g, w in zip(outs["port"], outs["jax"]):
        assert g.lod() == w.lod()
        n = g.lod()[0][-1]
        np.testing.assert_allclose(np.asarray(g.numpy())[:n],
                                   np.asarray(w.numpy())[:n])


def test_beam_search_end_to_end_vs_bruteforce():
    """A host-driven decode loop over a toy model whose step scores
    depend only on (t, prev_token): with K = C beams the search is exact
    and finds the brute-force best path of each source."""
    rs = np.random.RandomState(5)
    B, K, T, C = 2, 3, 4, 3
    end_id = 0
    table = (rs.rand(T, C, C) * -2.0).astype("float32")
    offset = np.array([0.0, -0.1], dtype="float32")

    def canon(path):
        out = []
        for tok in path:
            out.append(tok)
            if tok == end_id:
                break
        return tuple(out)

    def path_score(b, path):
        s, prev = offset[b], 1
        for t, tok in enumerate(path):
            s += table[t, prev, tok]
            prev = tok
        return s

    best = []
    for b in range(B):
        cands = {canon(p): None for p in itertools.product(range(C),
                                                           repeat=T)}
        best.append(max(cands, key=lambda p: path_score(b, p)))

    pre_ids = np.full((B * K, 1), -1, dtype="int64")
    pre_ids[::K, 0] = 1
    pre_scores = np.zeros((B * K, 1), dtype="float32")
    pre_scores[::K, 0] = offset
    hist = []
    for t in range(T):
        prev = np.where(pre_ids[:, 0] >= 0, pre_ids[:, 0], 1)
        cand = (pre_scores + table[t, prev]).astype("float32")
        ids = np.tile(np.arange(C, dtype="int64")[None, :], (B * K, 1))
        si, ss, par = run_step(pre_ids, ids, cand, K, end_id,
                               pre_scores=pre_scores)
        hist.append((si, ss, par))
        pre_ids, pre_scores = si.astype("int64"), ss.astype("float32")

    with tfluid.program_guard(tfluid.Program(), tfluid.Program()):
        iv = tfluid.layers.data(name="ids", shape=[B * K, 1], dtype="int64")
        sv = tfluid.layers.data(name="sc", shape=[B * K, 1],
                                dtype="float32")
        pv = tfluid.layers.data(name="par", shape=[B * K, 1], dtype="int64")
        fetch = tfluid.layers.beam_search_decode(iv, sv, parents=pv,
                                                 end_id=end_id)
        ids_lt, _ = tfluid.Executor(tfluid.CPUPlace()).run(
            feed={"ids": np.stack([h[0] for h in hist]),
                  "sc": np.stack([h[1] for h in hist]),
                  "par": np.stack([h[2] for h in hist])},
            fetch_list=list(fetch))
    lod = ids_lt.lod()[0]
    toks = np.asarray(ids_lt.numpy()).reshape(-1)
    for b in range(B):
        got = tuple(toks[lod[b * K]:lod[b * K + 1]].tolist())
        assert got == best[b], (b, got, best[b])


@pytest.mark.cuda
def test_beam_search_on_the_card_equals_the_host():
    """The step on the card, ties included, bitwise equal to the host."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    pre_ids, scores, pre_scores, K = _ties()
    host = _beam_step(tfluid, tfluid.CPUPlace(), pre_ids, None, scores, K,
                      1, pre_scores=pre_scores)
    card = _beam_step(tfluid, tfluid.CUDAPlace(0), pre_ids, None, scores,
                      K, 1, pre_scores=pre_scores)
    for c, h in zip(card, host):
        np.testing.assert_array_equal(c, h)
