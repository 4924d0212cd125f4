"""paddle_tpu_torch.cache: the compile cache behind the Executor.

The JAX package's cache tests (tests/test_compile_cache.py) held against
the port: L1's true LRU under FLAGS_compile_cache_cap with its counters
(and, on the recorded graph path, an evicted entry's CapturedStep freed
and recaptured bitwise equal), the program digest equal to the JAX
package's, process-stable L2 digests proven across subprocesses with
different PYTHONHASHSEEDs, the warm-start contract (the second process
prepares from the store, counts no miss and computes the same loss
bitwise), corrupt, stale and truncated entries that fall back — counted,
never raised — store maintenance (prune, clear), and
ParallelExecutor.compile_cache_info() on a one-rank gloo group (the `cache`
CLI is tests/test_torch_cli_check.py's). Also the
JAX package's four flags that act on XLA's scan carry or donation: values
bitwise equal with each on and off.
"""

import gc
import json
import os
import subprocess
import sys
import weakref

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.cache import program_digest as j_program_digest

import paddle_tpu_torch as fluid
from paddle_tpu_torch import amp, flags, monitor
from paddle_tpu_torch.cache import (CompileCache, L2Store, program_digest,
                                    stable_digest)
from paddle_tpu_torch.core import framework as tframework
from paddle_tpu_torch.core import scope as tscope
from paddle_tpu_torch.parallel import distributed as tdist

from test_torch_step import recorded_graphs  # noqa: F401 (a fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh_port_state():
    tframework.switch_main_program(tframework.Program())
    tframework.switch_startup_program(tframework.Program())
    tscope.reset_global_scope()
    fluid.unique_name.switch()
    flags.reset()
    monitor.reset()
    yield
    flags.reset()
    monitor.reset()


def _flip_tail(path, n=8):
    """Corrupt an entry's PAYLOAD in place (the tail is always payload)."""
    with open(path, "r+b") as f:
        f.seek(-n, 2)
        tail = f.read(n)
        f.seek(-n, 2)
        f.write(bytes(b ^ 0xFF for b in tail))


def _mlp(pkg=fluid):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data(name="x", shape=[8], dtype="float32")
        loss = pkg.layers.mean(pkg.layers.fc(input=x, size=4))
        pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss


def _momentum_net(pkg=fluid):
    """conv + batch_norm + fc under Momentum: the fusion pass buckets its
    updates, so its prepared plan is a rewritten program."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        img = pkg.layers.data(name="img", shape=[3, 8, 8], dtype="float32")
        lab = pkg.layers.data(name="lab", shape=[1], dtype="int64")
        c = pkg.layers.conv2d(img, num_filters=4, filter_size=3)
        b = pkg.layers.batch_norm(c, act="relu")
        p = pkg.layers.fc(b, size=5, act="softmax")
        loss = pkg.layers.mean(pkg.layers.cross_entropy(p, lab))
        pkg.optimizer.Momentum(learning_rate=0.1, momentum=0.9).minimize(loss)
        main.random_seed = startup.random_seed = 5
    return main, startup, loss


def _store_files(root):
    return sorted(f for f in os.listdir(root) if f.endswith(".aot"))


# ---------------------------------------------------------------------------
# L1: true LRU under FLAGS_compile_cache_cap
# ---------------------------------------------------------------------------
def test_l1_hot_entry_survives_cap_eviction():
    evicted = []
    cc = CompileCache("executor", on_evict=lambda k, e: evicted.append(k))
    with flags.flag_guard(compile_cache_cap=2):
        cc.put("a", 1)
        cc.put("b", 2)
        assert cc.get("a") == 1  # "a" is now the most recently used
        cc.put("c", 3)
    assert list(cc) == ["a", "c"]
    assert evicted == ["b"] and cc.evictions == 1


def test_l1_reput_of_resident_key_at_cap_evicts_nothing():
    cc = CompileCache("executor")
    with flags.flag_guard(compile_cache_cap=2):
        cc.put("a", 1)
        cc.put("b", 2)
        cc.put("a", 10)
    assert cc.evictions == 0 and dict(cc.items()) == {"a": 10, "b": 2}
    assert list(cc) == ["b", "a"]


def test_l1_counters_and_mapping_surface():
    cc = CompileCache("executor")
    assert cc.get("k") is None
    assert cc.get("k", count_miss=False) is None
    cc.put("k", "v")
    assert cc.get("k") == "v"
    assert (cc.hits, cc.misses) == (1, 1)
    assert len(cc) == 1 and "k" in cc and cc["k"] == "v"
    assert list(cc.keys()) == ["k"] and list(cc.values()) == ["v"]
    info = cc.info()
    assert (info["entries"], info["hits"], info["misses"],
            info["evictions"]) == (1, 1, 1, 0)
    assert info["l2"]["enabled"] is False and info["l2"]["dir"] is None
    assert (info["l2"]["remote_hits"], info["l2"]["remote_misses"]) == (0, 0)
    cc.clear()
    assert len(cc) == 0


def test_executor_cap_evicts_lru_and_counts(tmp_path):
    """Three feed shapes under cap 2, then the first again: two evictions,
    counted on the cache, the monitor and the step journal."""
    main, startup, loss = _mlp()
    journal = tmp_path / "journal.jsonl"
    with flags.flag_guard(compile_cache_cap=2, monitor=True,
                          monitor_journal=str(journal)):
        fluid.Executor(fluid.CPUPlace()).run(startup)
        exe = fluid.Executor(fluid.CPUPlace())
        for b in (8, 16, 32, 8):
            exe.run(main, feed={"x": np.ones((b, 8), np.float32)},
                    fetch_list=[loss])
        info = exe.compile_cache_info()
        snap = monitor.registry().snapshot()
    assert (info["entries"], info["evictions"]) == (2, 2)
    assert sum(v for k, v in snap.items()
               if "compile_cache_evictions_total" in k) == 2
    records = monitor.read_journal(str(journal))
    assert [r.get("cache_evictions", 0) for r in records[-4:]] == [0, 0, 1, 1]


def test_eviction_frees_the_captured_step_and_recaptures_bitwise(
        recorded_graphs):  # noqa: F811
    """On the graph path (recorded on the CPU), an evicted prepared step
    takes its CapturedStep with it — nothing else holds it, so it is
    collected — and the shape's next run prepares, warms up and captures
    again, with outputs bitwise equal to the first capture's. The card's
    own test (test_eviction_frees_graph_memory_on_the_card) measures the
    freed memory."""
    main, startup, _ = _momentum_net()
    test_prog = main.clone(for_test=True)
    fetch = next(op.output("Out")[0] for op in test_prog.global_block().ops
                 if op.type == "softmax")
    rs = np.random.RandomState(0)
    feeds = {b: rs.rand(b, 3, 8, 8).astype(np.float32) for b in (8, 16, 32)}
    with flags.flag_guard(compile_cache_cap=2):
        fluid.Executor(fluid.CPUPlace()).run(startup)
        exe = fluid.Executor(fluid.CPUPlace())

        def two(b):
            outs = [exe.run(test_prog, feed={"img": feeds[b]},
                            fetch_list=[fetch])[0] for _ in range(2)]
            return outs[-1]

        first = two(8)
        (step8,) = exe.captured_steps(test_prog)
        ref = weakref.ref(step8)
        del step8
        two(16)
        two(32)
        gc.collect()
        assert ref() is None  # evicted with its prepared step
        assert len(exe.captured_steps(test_prog)) == 2
        again = two(8)
        info = exe.compile_cache_info()
    assert info["evictions"] == 2
    np.testing.assert_array_equal(again, first)


# ---------------------------------------------------------------------------
# digests
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("builder", [_mlp, _momentum_net],
                         ids=["mlp", "momentum_net"])
def test_program_digest_equals_the_jax_packages(builder):
    """The same layer calls give the same desc_str, hence the same sha256
    (the momentum net aside for its batch_norm_grad: the port's leaves the
    running stats out, tests/test_torch_imports.py)."""
    tmain, _, _ = builder(fluid)
    jmain, _, _ = builder(jfluid)
    if builder is _mlp:
        assert program_digest(tmain) == j_program_digest(jmain)
    else:
        assert program_digest(tmain) != j_program_digest(jmain)


def test_program_digest_is_content_addressed():
    m1, _, _ = _mlp()
    m2, _, _ = _mlp()
    assert m1 is not m2
    assert program_digest(m1) == program_digest(m2)
    m1._mutation += 1
    assert program_digest(m1) == program_digest(m2)
    m3, s3 = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(m3, s3):
        x = fluid.layers.data(name="x", shape=[8], dtype="float32")
        fluid.layers.mean(fluid.layers.fc(input=x, size=5))
    assert program_digest(m3) != program_digest(m1)


def test_stable_digest_sensitive_to_tail_and_extra():
    m, _, _ = _mlp()
    base = stable_digest(m, (("amp-off",),))
    assert base == stable_digest(m, (("amp-off",),))
    assert base != stable_digest(m, (("amp", "bfloat16"),))
    assert base != stable_digest(m, (("amp-off",),),
                                 extra=(("kind", "parallel_executor"),))


_CHILD = """
import json, os, sys
import numpy as np
sys.path.insert(0, os.path.join(os.environ["REPO"], "tests"))
import paddle_tpu_torch as fluid
from paddle_tpu_torch import flags, monitor
from test_torch_compile_cache import _momentum_net

flags.set("monitor", True)
flags.set("fuse", True)
main, startup, loss = _momentum_net()
exe = fluid.Executor(fluid.CPUPlace())
exe.run(startup)
rs = np.random.RandomState(3)
feed = {"img": rs.rand(4, 3, 8, 8).astype("float32"),
        "lab": rs.randint(0, 5, (4, 1)).astype("int64")}
monitor.reset()
losses = [float(exe.run(main, feed=feed, fetch_list=[loss])[0].reshape(-1)[0])
          for _ in range(2)]
snap = monitor.registry().snapshot()
root = os.environ["FLAGS_compile_cache_dir"]
print(json.dumps({
    "digests": sorted(f[:-4] for f in os.listdir(root) if f.endswith(".aot")),
    "misses": sum(v for k, v in snap.items()
                  if "compile_cache_misses_total" in k),
    "info": exe.compile_cache_info(),
    "prepare": exe.last_prepare,
    "losses": [x.hex() for x in losses],
}))
"""


def _child(tmp_path, hashseed):
    script = tmp_path / "child.py"
    script.write_text(_CHILD)
    env = dict(os.environ, PYTHONHASHSEED=hashseed, REPO=REPO,
               PYTHONPATH=REPO,
               FLAGS_compile_cache_dir=str(tmp_path / "store"))
    proc = subprocess.run([sys.executable, str(script)], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_digest_and_warm_start_stable_across_processes(tmp_path):
    """The same program in two processes with DIFFERENT hash seeds lands
    on the same L2 key; the second takes the fused plan from the store
    (no fusion pass, no miss on the monitor) and its losses are the
    first's, bitwise. A corrupted entry then costs the third process one
    counted fallback, and it still runs to the same losses."""
    cold = _child(tmp_path, "1")
    warm = _child(tmp_path, "2")
    assert len(cold["digests"]) == 2, cold  # the startup and the main
    assert cold["digests"] == warm["digests"]
    assert cold["misses"] >= 1 and cold["info"]["l2"]["puts"] == 2
    assert "fusion" in cold["prepare"] and "level" not in cold["prepare"]
    assert warm["misses"] == 0, warm
    assert warm["info"]["l2"]["hits"] == 2 and warm["info"]["l2"]["puts"] == 0
    assert warm["prepare"]["level"] == "l2"
    assert "fusion" not in warm["prepare"]
    assert warm["losses"] == cold["losses"]
    for d in cold["digests"]:
        _flip_tail(os.path.join(tmp_path, "store", d + ".aot"))
    hurt = _child(tmp_path, "3")
    assert hurt["info"]["l2"]["fallbacks"] == 2, hurt
    assert hurt["info"]["l2"]["puts"] == 2  # prepared afresh, stored again
    assert hurt["losses"] == cold["losses"]


def test_l2_hit_verifies_when_the_entry_was_stored_unverified(tmp_path):
    """An entry stored with FLAGS_verify off is checked when a prepare
    asks for `full`; one stored at `full` skips the check. Each executor
    here is a fresh L1, as a restarted process's."""
    main, startup, loss = _momentum_net()
    rs = np.random.RandomState(4)
    feed = {"img": rs.rand(4, 3, 8, 8).astype(np.float32),
            "lab": rs.randint(0, 5, (4, 1)).astype(np.int64)}
    fluid.Executor(fluid.CPUPlace()).run(startup)

    def prepare(verify):
        exe = fluid.Executor(fluid.CPUPlace())
        with flags.flag_guard(verify=verify):
            exe.run(main, feed=feed, fetch_list=[loss])
        return exe.last_prepare

    with flags.flag_guard(compile_cache_dir=str(tmp_path), fuse=True):
        stored = prepare("off")
        checked = prepare("full")
        assert L2Store(str(tmp_path)).clear() == 1
        verified = prepare("full")
        skipped = prepare("full")
    assert "level" not in stored and "verify" not in stored
    assert checked["level"] == "l2" and "verify" in checked
    assert "level" not in verified and "verify" in verified
    assert skipped["level"] == "l2" and "verify" not in skipped


def test_flag_flip_changes_l2_key(tmp_path):
    """A config that changes the prepared step (amp here) lands on a NEW
    L2 digest."""
    main, startup, loss = _mlp()
    feed = {"x": np.ones((4, 8), np.float32)}
    with flags.flag_guard(compile_cache_dir=str(tmp_path)):
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        exe.run(main, feed=feed, fetch_list=[loss])
        before = set(_store_files(tmp_path))
        with amp.auto_cast():
            exe.run(main, feed=feed, fetch_list=[loss])
        after = set(_store_files(tmp_path))
    assert before and after > before


def test_corrupt_entry_falls_back_and_self_heals(tmp_path):
    main, startup, loss = _momentum_net()
    rs = np.random.RandomState(1)
    feed = {"img": rs.rand(4, 3, 8, 8).astype(np.float32),
            "lab": rs.randint(0, 5, (4, 1)).astype(np.int64)}
    fluid.Executor(fluid.CPUPlace()).run(startup)
    with flags.flag_guard(compile_cache_dir=str(tmp_path), monitor=True,
                          fuse=True):
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(main, feed=feed, fetch_list=[loss])
        paths = [os.path.join(tmp_path, f) for f in _store_files(tmp_path)]
        assert len(paths) == 1 and exe.compile_cache_info()["l2"]["puts"] == 1
        _flip_tail(paths[0])
        exe._prepared.clear()  # the L1 miss a restarted process takes
        out, = exe.run(main, feed=feed, fetch_list=[loss])
        info = exe.compile_cache_info()
        snap = monitor.registry().snapshot()
        last = monitor.last_step()
    assert np.isfinite(out).all()
    assert info["l2"]["fallbacks"] == 1 and info["l2"]["puts"] == 2
    assert sum(v for k, v in snap.items()
               if "compile_cache_l2_fallbacks_total" in k) == 1
    assert last["cache_l2_fallback"] == "corrupt"
    store = L2Store(str(tmp_path))
    assert [store.get(e["digest"])[0] for e in store.entries()] == ["hit"]


def test_undecodable_entry_is_a_counted_fallback(tmp_path):
    """An entry whose framing and checksum hold but whose payload is not a
    prepared plan falls back too (the reference's deserialize failure)."""
    main, startup, loss = _mlp()
    feed = {"x": np.ones((4, 8), np.float32)}
    scope = fluid.global_scope()
    fluid.Executor(fluid.CPUPlace()).run(startup)
    init = {n: fluid.fetch_var(n, scope) for n in scope.local_var_names()}
    with flags.flag_guard(compile_cache_dir=str(tmp_path)):
        exe = fluid.Executor(fluid.CPUPlace())
        want, = exe.run(main, feed=feed, fetch_list=[loss])
        (name,) = _store_files(tmp_path)
        L2Store(str(tmp_path)).put(name[:-4], b"not a plan")
        exe._prepared.clear()
        for n, v in init.items():
            scope.set_var(n, torch.from_numpy(v))
        got, = exe.run(main, feed=feed, fetch_list=[loss])
        info = exe.compile_cache_info()
    assert info["l2"]["fallbacks"] == 1
    np.testing.assert_array_equal(got, want)


def test_store_version_mismatch_is_stale(tmp_path, monkeypatch):
    store = L2Store(str(tmp_path))
    digest = "d" * 64
    store.put(digest, b"payload-bytes")
    assert store.get(digest)[0] == "hit"
    import paddle_tpu_torch.cache.store as store_mod

    monkeypatch.setattr(store_mod, "environment",
                        lambda: ("0.0.0", "11.0", "another card", "sm_70"))
    outcome, payload, header = store.get(digest)
    assert outcome == "stale" and payload is None
    assert header["torch"] == torch.__version__  # the real header, for ls


def test_store_corrupt_truncated_garbage_and_miss(tmp_path):
    store = L2Store(str(tmp_path))
    digest = "a" * 64
    store.put(digest, b"x" * 100)
    path = store.path_for(digest)
    _flip_tail(path, 4)  # payload bit-flip -> checksum mismatch
    assert store.get(digest)[0] == "corrupt"
    with open(path, "rb") as f:
        blob = f.read()
    with open(path, "wb") as f:
        f.write(blob[:len(blob) // 2])  # torn write
    assert store.get(digest)[0] == "corrupt"
    with open(path, "wb") as f:
        f.write(b"not a cache entry")  # foreign debris
    assert store.get(digest)[0] == "corrupt"
    ents = store.entries()
    assert len(ents) == 1 and ents[0]["ok"] is False
    assert store.get("b" * 64)[0] == "miss"


def test_store_prune_is_mtime_lru_and_clear_empties(tmp_path):
    store = L2Store(str(tmp_path))
    for i, digest in enumerate(("a" * 64, "b" * 64, "c" * 64)):
        store.put(digest, bytes(100))
        os.utime(store.path_for(digest), (i, i))  # a oldest, c newest
    total = store.total_bytes()
    assert store.prune(total - 1) == 1
    assert not os.path.exists(store.path_for("a" * 64))
    assert os.path.exists(store.path_for("c" * 64))
    assert store.prune(total) == 0
    assert store.clear() == 2
    assert store.entries() == [] and store.total_bytes() == 0


def test_put_blob_validates_framing_digest_binding_and_checksum(tmp_path):
    src, dst = L2Store(str(tmp_path / "a")), L2Store(str(tmp_path / "b"))
    digest = "e" * 64
    src.put(digest, b"plan-bytes")
    blob = src.read_blob(digest)
    assert not dst.put_blob("f" * 64, blob)  # bound to another digest
    assert not dst.put_blob(digest, blob[:-1])  # truncated
    assert dst.put_blob(digest, blob)
    assert dst.get(digest)[:2] == ("hit", b"plan-bytes")


# ---------------------------------------------------------------------------
# the four accepted flags: values bitwise equal on and off
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["fuse_optimizer_ops", "pack_small_state",
                                  "fold_ema_multi_step",
                                  "donate_feed_buffers"])
def test_scan_carry_and_donation_flags_change_no_value(name):
    main, startup, loss = _momentum_net()
    rs = np.random.RandomState(2)
    feed = {"img": rs.rand(3, 4, 3, 8, 8).astype(np.float32),
            "lab": rs.randint(0, 5, (3, 4, 1)).astype(np.int64)}
    default = flags.get(name)

    def run(value):
        scope = fluid.Scope()
        with fluid.scope_guard(scope), flags.flag_guard(**{name: value},
                                                        fuse=True):
            exe = fluid.Executor(fluid.CPUPlace())
            exe.run(startup)
            pipe = fluid.DataPipe(
                [{n: v[k] for n, v in feed.items()} for k in range(3)]
            ).prefetch_to_device(place=fluid.CPUPlace(), chunk=3,
                                 donate=True) \
                if name == "donate_feed_buffers" else None
            out, = exe.run(main, feed=pipe if pipe is not None else feed,
                           fetch_list=[loss], iters=3)
            return out, {n: fluid.fetch_var(n, scope)
                         for n in sorted(scope.local_var_names())}

    want = run(default)
    got = run(not default)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1].keys() == want[1].keys()
    for n in want[1]:
        np.testing.assert_array_equal(got[1][n], want[1][n])


def test_compile_service_is_refused_while_set():
    main, startup, loss = _mlp()
    exe = fluid.Executor(fluid.CPUPlace())
    with flags.flag_guard(compile_service="localhost:1"):
        with pytest.raises(NotImplementedError, match="item 8"):
            exe.run(startup)
    assert exe.compile_cache_info()["l2"]["service"] is None


# ---------------------------------------------------------------------------
# ParallelExecutor
# ---------------------------------------------------------------------------
def test_parallel_executor_compile_cache_info_one_rank(tmp_path):
    """At W = 1 over gloo PE's compile_cache_info is its rank's cache,
    with the kind that labels its L2 entries."""
    tdist.initialize("file://" + str(tmp_path / "rendezvous"), 1, 0)
    try:
        main, startup, loss = _mlp()
        fluid.Executor(fluid.CPUPlace()).run(startup)
        with flags.flag_guard(compile_cache_dir=str(tmp_path / "store")):
            pe = fluid.ParallelExecutor(use_cuda=False, loss_name=loss.name,
                                        main_program=main)
            for _ in range(2):
                pe.run([loss], feed={"x": np.ones((4, 8), np.float32)})
            info = pe.compile_cache_info()
            ents = L2Store(str(tmp_path / "store")).entries()
    finally:
        torch.distributed.destroy_process_group()
    assert (info["entries"], info["hits"], info["misses"]) == (1, 1, 1)
    assert info["l2"]["puts"] == 1
    assert [e["kind"] for e in ents] == ["parallel_executor"]
