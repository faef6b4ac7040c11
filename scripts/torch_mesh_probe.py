#!/usr/bin/env python3
"""Probe the collectives sharded serving runs on one card.

    python3 scripts/torch_mesh_probe.py

Needs a CUDA card.  Prints the card and two JSON lines:

- ``gloo4``: four rank processes on the one card over gloo (nccl refuses
  two ranks of one communicator on one device): a bf16, f32 and int64
  all-reduce's sums (each rank adds rank + 1: 10), the ms of an
  all-reduce of a decode step's [32, 4096] bf16 activations (256 KB, mean
  of 64) and of a [8192, 4096] one (64 MB, mean of 4), and a list
  all-gather of CUDA tensors;
- ``one_rank``: a one-rank nccl group's all-reduce and all-gather captured
  in a CUDA graph and replayed (``replay_value`` 7.0 when the replay ran
  them: (3 * 2) summed over one rank, plus 1).
"""

import json
import os
import subprocess
import sys
import time
from datetime import timedelta

import torch
import torch.distributed as dist


def one_rank() -> None:
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group("cpu:gloo,cuda:nccl", store=dist.HashStore(), rank=0, world_size=1)
    torch.cuda.set_device(0)
    mesh = init_device_mesh("cuda", (1, 1, 1), mesh_dim_names=("dp", "fsdp", "tp"))
    group = mesh.get_group("tp")
    out = {"backend": str(dist.get_backend(group))}
    static = torch.ones(4, 8, device="cuda", dtype=torch.bfloat16)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm the communicator outside the capture
        for _ in range(2):
            warm = static * 2
            dist.all_reduce(warm, group=group)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph, stream=torch.cuda.Stream(), capture_error_mode="thread_local"):
            summed = static * 2
            dist.all_reduce(summed, group=group)
            gathered = torch.empty(4, 8, device="cuda", dtype=torch.bfloat16)
            dist.all_gather_into_tensor(gathered, summed, group=group)
            result = gathered + 1
        static.fill_(3.0)
        graph.replay()
        torch.cuda.synchronize()
        out.update(captured=True, replay_value=float(result[0, 0]))
    except Exception as exc:  # noqa: BLE001 - the finding to print
        out.update(captured=False, error=repr(exc)[:500])
    print(json.dumps({"one_rank": out}), flush=True)
    dist.destroy_process_group()


def rank_main(rank: int, world: int, store: str) -> None:
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=timedelta(seconds=60))
    torch.cuda.set_device(0)
    out = {}
    for dtype in (torch.bfloat16, torch.float32, torch.int64):
        x = torch.full((32, 4096), rank + 1, device="cuda", dtype=dtype)
        dist.all_reduce(x)
        torch.cuda.synchronize()
        out[str(dtype)] = float(x[0, 0])
    for label, rows, iters in (("ms_per_allreduce_256KB", 32, 64),
                               ("ms_per_allreduce_64MB", 8192, 4)):
        x = torch.ones(rows, 4096, device="cuda", dtype=torch.bfloat16)
        torch.cuda.synchronize()
        started = time.perf_counter()
        for _ in range(iters):
            dist.all_reduce(x)
        torch.cuda.synchronize()
        out[label] = (time.perf_counter() - started) / iters * 1e3
    parts = [torch.empty(4, device="cuda") for _ in range(world)]
    dist.all_gather(parts, torch.full((4,), float(rank), device="cuda"))
    torch.cuda.synchronize()
    out["all_gather_cuda"] = [float(p[0]) for p in parts]
    if rank == 0:
        print(json.dumps({"gloo4": out}), flush=True)
    dist.destroy_process_group()


def main() -> int:
    if len(sys.argv) > 1:
        rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
        return 0
    if not torch.cuda.is_available():
        print("torch_mesh_probe: no CUDA device", file=sys.stderr)
        return 2
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    store = os.path.join(os.environ.get("TMPDIR", "/tmp"), f"torch_mesh_probe_{os.getpid()}")
    procs = [subprocess.Popen([sys.executable, __file__, str(rank), "4", store])
             for rank in range(4)]
    codes = [proc.wait(timeout=300) for proc in procs]
    if os.path.exists(store):
        os.remove(store)
    one_rank()
    return max(codes)


if __name__ == "__main__":
    sys.exit(main())
