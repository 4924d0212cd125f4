"""One rank of a multi-process run of paddle_tpu_torch's ring attention and
the P2P permutes over the mesh's sp and pp axes.

    python tests/torch_ring_worker.py SPEC.json RANK

SPEC.json holds {"world": W, "rendezvous": <path of a file that does not
exist yet>, "out": <dir>, "cuda": bool, "cases": [...]}. The rank joins a
W-rank gloo group through `parallel.distributed.initialize("file://...")`
— on the host, or with "cuda" on card 0 (every rank sharing it, its
permutes through pinned host buffers) — runs every case in order and
writes `<out>/<case name>.<rank>.npz`. A case is
  {"kind": "ring", "name", "seed", "shape": [B, H, S, D], "causal",
   "flash", "grads", "dtype"}: the global q, k, v (and with grads a
    cotangent dout) of `ring_inputs`, this rank's sequence shard of each,
    and on the mesh {"sp": W}: `ring_flash_attention` (flash) or
    `ring_attention`, its output shard, with grads its q/k/v grads of
    sum(out * dout), and the flash launches and permute launches counted
    in the run;
  {"kind": "ops", "name", "seed", "mesh": {axis: size}}: on that mesh,
    `collective_permute` over sp (a rotation), `pipeline_send` over pp
    (one hop), `pipeline_recv`, and the permute's gradient, each through
    its registered kernel, of `op_input(seed, rank)`.
This module imports paddle_tpu_torch and nothing of the JAX package; the
tests import `ring_inputs` and `op_input` to make the same inputs on the
JAX side, and `launch` to run the ranks.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np


def ring_inputs(seed, shape, grads=False):
    """The global q, k, v [B, H, S, D] float32 (and the cotangent dout)."""
    rs = np.random.RandomState(seed)
    out = {n: rs.randn(*shape).astype(np.float32) for n in ("q", "k", "v")}
    if grads:
        out["dout"] = rs.randn(*shape).astype(np.float32)
    return out


def op_input(seed, rank):
    """This rank's [4, 3] input to the permute ops."""
    return np.random.RandomState(seed * 100 + rank).randn(4, 3).astype(
        np.float32)


def _shard(x, rank, world):
    s = x.shape[2] // world
    return np.ascontiguousarray(x[:, :, rank * s:(rank + 1) * s])


def _ring(case, world, rank, device):
    import torch
    from paddle_tpu_torch.ops import collective_ops
    from paddle_tpu_torch.parallel import flash, make_mesh
    from paddle_tpu_torch.parallel import ring

    mesh = make_mesh({"sp": world})
    dtype = getattr(torch, case.get("dtype", "float32"))
    glob = ring_inputs(case["seed"], case["shape"], case.get("grads", False))
    t = {n: torch.from_numpy(_shard(a, rank, world)).to(device, dtype)
         for n, a in glob.items()}
    flash.reset_launch_counts()
    collective_ops.reset_launch_counts()
    res = {}
    if case["flash"]:
        out = ring.ring_flash_attention(t["q"], t["k"], t["v"], mesh,
                                        causal=case["causal"])
    else:
        for n in ("q", "k", "v"):
            t[n].requires_grad_(case.get("grads", False))
        out = ring.ring_attention(t["q"], t["k"], t["v"], mesh,
                                  causal=case["causal"])
        if case.get("grads"):
            (out.float() * t["dout"].float()).sum().backward()
            for n in ("q", "k", "v"):
                res["d" + n] = t[n].grad.float().cpu().numpy()
    res["out"] = out.detach().float().cpu().numpy()
    res["flash_launches"] = np.int64(flash.flash_fwd.launches)
    res["permute_launches"] = np.int64(collective_ops.launch.launches)
    res["host_staged_bytes"] = np.int64(
        collective_ops.permute.host_staged_bytes)
    return res


def _ops(case, world, rank, device):
    import torch
    from paddle_tpu_torch import CPUPlace, CUDAPlace
    from paddle_tpu_torch.core import registry
    from paddle_tpu_torch.core.executor_core import OpContext
    from paddle_tpu_torch.ops import collective_ops
    from paddle_tpu_torch.parallel import make_mesh

    mesh = make_mesh(case["mesh"])
    ctx = OpContext(CUDAPlace(0) if device.type == "cuda" else CPUPlace(),
                    dp=mesh)
    x = torch.from_numpy(op_input(case["seed"], rank)).to(device)

    def run(op_type, **attrs):
        return registry.run_kernel(registry.lookup(op_type), ctx,
                                   {"X": [x]}, attrs)["Out"][0]

    sp = mesh.axis("sp")
    n = sp.size if sp is not None else 1
    res = {"permute": run("collective_permute", axis_name="sp",
                          perm=[[i, (i + 1) % n] for i in range(n)]),
           "send": run("pipeline_send", axis_name="pp", peer=1),
           "recv": run("pipeline_recv", axis_name="pp", peer=1),
           "dp_permute": run("collective_permute", axis_name="dp",
                             perm=[[0, 0]])}
    xg = x.clone().requires_grad_(True)
    y = collective_ops.permute(xg, sp, [(i, (i + 1) % n) for i in range(n)])
    (y * (rank + 1)).sum().backward()
    res["permute_grad"] = xg.grad
    res["coords"] = np.array([mesh.axes[a].rank for a in mesh.shape])
    return {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else v) for k, v in res.items()}


def launch(world, cases, tmp_dir, timeout=120, cuda=False):
    """Run `cases` on `world` ranks, one process each (on the host, or with
    `cuda` all on card 0 over gloo), rendezvousing through a file in
    `tmp_dir`; returns {case name: [rank 0's results, ...]}. Every rank is
    killed once `timeout` seconds have passed, and a rank that fails or is
    killed fails the call with its output."""
    os.makedirs(tmp_dir, exist_ok=True)
    spec = {"world": world, "out": tmp_dir, "cases": cases, "cuda": cuda,
            "rendezvous": os.path.join(tmp_dir, f"rendezvous.{world}")}
    spec_path = os.path.join(tmp_dir, f"spec.{world}.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), spec_path, str(r)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    deadline = time.monotonic() + timeout
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(
                timeout=max(deadline - time.monotonic(), 1))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {r} of {world} exited "
                               f"{p.returncode}:\n{log}")
    return {c["name"]: [dict(np.load(os.path.join(
        tmp_dir, f"{c['name']}.{r}.npz"))) for r in range(world)]
        for c in cases}


def main(spec_path, rank):
    import torch
    from paddle_tpu_torch.parallel import distributed

    with open(spec_path) as f:
        spec = json.load(f)
    world = spec["world"]
    torch.manual_seed(0)
    distributed.initialize("file://" + spec["rendezvous"], world, rank,
                           local_device_ids=[0] if spec["cuda"] else None,
                           backend="gloo")
    device = torch.device("cuda", 0) if spec["cuda"] else \
        torch.device("cpu")
    try:
        for case in spec["cases"]:
            fn = {"ring": _ring, "ops": _ops}[case["kind"]]
            res = fn(case, world, rank, device)
            np.savez(os.path.join(spec["out"], f"{case['name']}.{rank}.npz"),
                     **res)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
