"""One worker of an elastic data-parallel drill of paddle_tpu_torch on the
host (gloo), and the net and feeds the tests hold it to.

    python tests/torch_elastic_worker.py SPEC.json NAME [--joiner]

SPEC.json holds {"master": "host:port" of a parallel.master.MasterService,
"checkpoint_dir": <dir shared by the workers>, "out": <dir>, "init":
<npz of the start state>, "steps": N, "start_world": W, "preempt": {name:
step}, "join": {name: {"at": step, "names": [...]}}, "deadline_s": S,
"cuda": bool}. With "cuda" every worker is a card rank on card 0 (the
ranks share it: a gloo group formed on the card, TF32 off), its step on
the interpreter, its collectives through pinned host buffers.
The worker builds `build()`'s net, loads the start state
(convert.load_numpy_state), and trains it through a ParallelExecutor
under a ResilientRunner holding an ElasticController (ConstantRescale, a
MeshSpec: the controller forms the gloo group and re-forms it at every
resize). A worker named in "preempt" takes chaos worker_preempt after
that step (it drains and exits); one named in "join" takes worker_join
after its step, spawning each name as `--joiner`, and then every
incumbent waits at that boundary until all joiners joined the
membership, and polls (the resize happens there on every rank). A
joiner adopts the committed checkpoint and trains from its step. Each
worker writes `<out>/<name>[.joiner].json`: the global steps it ran, in
order, their losses, the worlds of its resizes, whether it left, the
steps it started from, its steps' mode and the bytes its collectives
staged through the host. The process ends itself past "deadline_s"
(faulthandler), and waits for (or kills) the joiners it spawned.
This module imports paddle_tpu_torch and nothing of the JAX package; the
tests import `build` and `feed` to run the same net on the JAX side.
"""

import faulthandler
import json
import os
import sys
import time

import numpy as np


def build(fluid):
    """The JAX elastic test's net: fc 8 relu -> fc 1, squared error,
    SGD(0.1), under fresh unique names."""
    fluid.unique_name.switch()
    main, start = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, start):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        h = fluid.layers.fc(x, 8, act="relu")
        p = fluid.layers.fc(h, 1)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(p, y))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, start, loss


def feed(step):
    """The same global batch of 8 rows a step, whatever the world: dp
    only splits it."""
    rng = np.random.RandomState(1000 + step)
    return {"x": rng.standard_normal((8, 4)).astype(np.float32),
            "y": rng.standard_normal((8, 1)).astype(np.float32)}


def main(spec_path, name, joiner):
    import torch

    torch.set_num_threads(1)
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.ops import collective_ops
    from paddle_tpu_torch.parallel import MeshSpec
    from paddle_tpu_torch.parallel.elastic import (ConstantRescale,
                                                   ElasticConfig,
                                                   ElasticController,
                                                   Resized)
    from paddle_tpu_torch.resilience import (Preempted, ResilienceConfig,
                                             ResilientRunner, chaos)

    with open(spec_path) as f:
        spec = json.load(f)
    faulthandler.dump_traceback_later(spec["deadline_s"], exit=True)
    cuda = spec.get("cuda", False)
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    place = fluid.CUDAPlace(0) if cuda else fluid.CPUPlace()
    main_prog, start, loss = build(fluid)
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        fluid.Executor(place).run(start)
    convert.load_numpy_state(scope, main_prog, dict(np.load(spec["init"])),
                             place)
    monkey = chaos.ChaosMonkey()
    if not joiner and name in spec["preempt"]:
        monkey.add(chaos.Fault("worker_preempt", at=spec["preempt"][name]))
    join = None if joiner else spec["join"].get(name)
    if join is not None:
        for other in join["names"]:
            monkey.add(chaos.Fault("worker_join", at=join["at"], argv=[
                sys.executable, os.path.abspath(__file__), spec_path,
                other, "--joiner"]))
    chaos.install(monkey)
    ctl = ElasticController(ElasticConfig(
        spec["master"], name=name, ttl=10.0, heartbeat_interval=0.05,
        start_world=None if joiner else spec["start_world"],
        barrier_timeout=30.0, resize_timeout=60.0,
        policy=ConstantRescale(), mesh_spec=MeshSpec(),
        local_device_ids=[0] if cuda else None, backend="gloo"))
    runner = ResilientRunner(
        ResilienceConfig(checkpoint_dir=spec["checkpoint_dir"],
                         async_checkpoints=False, restore_on_start=False,
                         save_on_preempt=False, elastic=ctl),
        scope=scope, program=main_prog, place=place)

    def make_pe():
        return fluid.ParallelExecutor(use_cuda=cuda, loss_name=loss.name,
                                      main_program=main_prog)

    grow_at = max((j["at"] for j in spec["join"].values()), default=-1)
    res = {"name": name, "joiner": joiner, "order": [], "losses": {},
           "worlds": [], "left": False, "first_step": None,
           "start_world": None, "modes": []}
    collective_ops.reset_launch_counts()
    try:
        with fluid.scope_guard(scope), runner.session():
            res["start_world"] = ctl.world_size
            if joiner:
                manifest = runner.adopt(
                    expect_mesh=MeshSpec().geometry(ctl.world_size))
                assert manifest is not None, "nothing committed to adopt"
            pe = make_pe()
            while runner.global_step < spec["steps"]:
                s = runner.global_step
                if res["first_step"] is None:
                    res["first_step"] = s
                out, = runner.run_step(
                    lambda: pe.run([loss.name], feed=feed(s)))
                res["order"].append(s)
                res["losses"][str(s)] = float(np.asarray(out).reshape(()))
                res["modes"].append(pe.step_mode())
                try:
                    runner.after_step([out])
                    if s == grow_at and ctl.world_size < spec["start_world"]:
                        # the joiners are on their way: every incumbent
                        # waits here until all of them joined, then takes
                        # the resize at this boundary
                        deadline = time.monotonic() + 60.0
                        while not ctl.resize_pending() or len(
                                ctl.membership()["members"]) \
                                < spec["start_world"]:
                            assert time.monotonic() < deadline, \
                                "the joiners never joined"
                            time.sleep(0.02)
                        ctl.poll(runner)
                except Resized as r:
                    res["worlds"].append(r.world_size)
                    pe = make_pe()
    except Preempted:
        res["left"] = True
    res["resizes"] = ctl.resizes
    res["host_staged_bytes"] = collective_ops.launch.host_staged_bytes
    suffix = ".joiner" if joiner else ""
    with open(os.path.join(spec["out"], f"{name}{suffix}.json"), "w") as f:
        json.dump(res, f)
    for p in monkey.spawned:
        try:
            p.wait(timeout=spec["deadline_s"])
        except Exception:  # noqa: BLE001 — a wedged joiner is killed
            p.kill()
            p.wait()
    chaos.uninstall()
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], "--joiner" in sys.argv[3:])
