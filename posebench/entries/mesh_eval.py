"""``BatchedEvaluator.run_batch`` on a (chips x 1) data mesh over NCCL:
one process per card through the program's ``parallel/mesh.launch``;
every rank is given the same global batch, runs its block through the
backbone and the decode, and the padded results are gathered, so that
each rank returns every image's humans (the sharded evaluation user).

The ranks agree once per call, over a gloo group on the host, whether
rank 0's window is still open, so that no rank starts a collective the
others skip. The parent process waits: it touches no card while the
ranks run.
"""

from __future__ import annotations

import time

import numpy as np
import torch


def _rank(workload: str, seed: int, seconds: float, trace: bool,
          root: str, t_start: float, devices) -> dict:
    import torch.distributed as dist

    from posebench.entries import _program
    from posebench.lib import weights
    from posebench.lib.cell import Cell, humans_px
    from posebench.lib.trace import Tracer
    from tfpose_tpu_torch.evaluation.sweep import BatchedEvaluator
    from tfpose_tpu_torch.parallel.halo import row_bounds
    from tfpose_tpu_torch.parallel.mesh import make_mesh, replicated

    cell = Cell(workload, seed, seconds, trace, root=root, t_start=t_start)
    cell.render()
    n = cell.workload["chips"]
    mesh = make_mesh(n, 1, devices)
    cfg = cell.config
    ev = BatchedEvaluator(cfg["model"], (cell.w, cell.h),
                          batch_size=cell.batch, dtype=cfg["dtype"],
                          upsample=cfg["upsample"], mesh=mesh)
    path = cell.weights_path()
    if path is None:
        weights.load_into(ev.net, weights.seeded_tree(cfg["model"], seed,
                                                      mesh.device))
        replicated(mesh, ev.net)
    else:
        ev.load_params(path)
    hook = _program.MapsHook(ev.net)
    bounds = row_bounds(cell.batch, n)
    lo, hi = bounds[mesh.data_index], bounds[mesh.data_index + 1]
    batches = {}

    def batch(i):
        key = (i * cell.batch) % len(cell.pool)
        if key not in batches:
            batches[key] = np.stack([cell.pool[s] for s in cell.scenes_of(i)])
        return batches[key]

    for i in range(cell.workload["warmup_calls"]):
        ev.run_batch(batch(i))
    _program.synchronize(mesh.device)
    ctl = dist.new_group(backend="gloo")
    flag = torch.ones(1, dtype=torch.int32)
    dist.barrier(group=ctl)
    keeper, lat = cell.keeper(), []
    tracer = Tracer(trace, cell.workload["trace_calls"])
    tracer.start()
    setup_end = time.time()
    t0 = time.perf_counter()
    end = t0 + seconds
    i = 0
    while True:
        t = time.perf_counter()
        flag[0] = int(t < end) if mesh.rank == 0 else 1
        dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=ctl)
        if not flag[0]:
            break
        with tracer.call(i):
            humans = ev.run_batch(batch(i))
        keeper.offer(i, (cell.scenes_of(i), hook.maps,
                         humans if mesh.rank == 0 else None))
        lat.append(time.perf_counter() - t)
        i += 1
    window_s = time.perf_counter() - t0
    tracer.close()
    peak = _program.memory_peak(mesh.device)
    kept = []
    for scenes, maps, humans in keeper.kept():   # to the host, once
        call = {"scenes": scenes[lo:hi], "maps": maps.float().cpu().numpy()}
        if humans is not None:
            call["humans_all"] = [humans_px(h, cell.up_w, cell.up_h)
                                  for h in humans]
            call["scenes_all"] = scenes
        kept.append(call)
    return {"latencies_s": lat, "calls": i, "window_s": window_s,
            "setup_end": setup_end, "memory_peak_bytes": peak,
            "kept": kept, "trace": tracer.summary,
            "traced_calls": tracer.traced_calls, "local_batch": hi - lo,
            "kind": (torch.cuda.get_device_name(mesh.device)
                     if mesh.device.type == "cuda" else "cpu")}


def run(cell):
    from posebench.entries import _program
    from tfpose_tpu_torch.ops.kernels import build
    from tfpose_tpu_torch.parallel.mesh import launch

    _program.closed_loop(cell)
    n = cell.workload["chips"]
    if torch.device(cell.device).type == "cuda":
        build.build_all()     # once, before the ranks load the libraries
        devices, backend = [f"cuda:{r}" for r in range(n)], "nccl"
    else:   # the CPU tests: gloo ranks running the kernels' plain versions
        devices, backend = ["cpu"] * n, "gloo"
    outs = launch(_rank, n, devices, backend, cell.workload["name"],
                  cell.seed, cell.seconds, cell.trace, cell.root,
                  cell.t_start, devices, timeout=300.0)
    cell.render()
    r0 = outs[0]
    kept = []
    for j, call in enumerate(r0["kept"]):
        maps = np.concatenate([o["kept"][j]["maps"] for o in outs])
        kept.append({"scenes": call["scenes_all"], "maps": maps,
                     "humans": call["humans_all"]})
    images = r0["calls"] * cell.batch
    return {"latencies_s": r0["latencies_s"], "calls": r0["calls"],
            "window_s": r0["window_s"], "setup_s": r0["setup_end"]
            - cell.t_start, "memory_peak_bytes": max(
                o["memory_peak_bytes"] for o in outs),
            "kept": kept, "images": images, "attempted": images,
            "failed": 0, "traces": [o["trace"] for o in outs if o["trace"]],
            "traced_calls": r0["traced_calls"],
            "local_batch": r0["local_batch"], "kind": r0["kind"]}
