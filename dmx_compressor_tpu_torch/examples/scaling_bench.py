"""Tensor- and data-parallel scaling harness: tokens/s at each (dp, tp).

Port of ``examples/scaling_bench.py``.  For each mesh shape it builds OPT
(BASIC mode, random weights from seed 0; OPT-125m on the card, a tiny OPT
on the CPU), shards it with ``parallel.shard_state`` over (dp, tp), feeds
each dp rank its share of an 8 * dp x 128 batch and times the best of 3
forwards (the slowest rank's); the efficiency is tokens/s over (dp * tp)
times the (1, 1) figure.  From the root of a checkout:

    python -m dmx_compressor_tpu_torch.examples.scaling_bench \\
        [--world N] [--backend nccl|gloo] [--device cuda|cpu]

It spawns ``--world`` ranks (default: the cards there are, at least one;
rank r takes card r mod the count) over a ``FileStore`` and measures
(1, 1), then (2, 1), (1, 2), (2, 2), (4, 1), (4, 2) and (8, 1) as far as
the world allows; a rank outside a shape's mesh waits.  Ranks that share
one card (``--world 2`` on one card, with ``--backend gloo``: NCCL refuses
two ranks on one card) measure correctness and overhead, not scaling.
Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import List, Sequence, Tuple

import numpy as np
import torch

SHAPES = [(1, 1), (2, 1), (1, 2), (2, 2), (4, 1), (4, 2), (8, 1)]


def config(device: torch.device):
    from ..models.opt import OPTConfig

    if device.type == "cuda":
        return OPTConfig.opt_125m()
    # 128 wide, heads of 64: tp 2 keeps whole BFP blocks
    return OPTConfig(vocab_size=512, hidden_size=128, ffn_dim=256, num_hidden_layers=2,
                     num_attention_heads=2, max_position_embeddings=256)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(mesh_shape: Tuple[int, int], cfg, device, batch: int = 8, seq: int = 128,
            reps: int = 3) -> dict:
    """One shape's tokens/s, inside a process group whose world holds at
    least dp * tp ranks (every rank calls it; a rank outside the mesh waits
    and gets the same numbers).  The time is the slowest rank's best
    forward."""
    import torch.distributed as dist

    from ..modeling.model import DmxModel
    from ..models.opt import OPTForCausalLM
    from ..parallel import host_local_batch, make_mesh, shard_state

    dp, tp = mesh_shape
    mesh = make_mesh((dp, tp), ("dp", "tp"), device_type=device.type)
    best = float("inf")
    if mesh.get_coordinate() is not None:
        with torch.no_grad():
            model = OPTForCausalLM(cfg, device=device, seed=0)
            DmxModel.from_raw(model).to_basic_mode()
            shard_state(model, mesh)
            ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (batch * dp, seq))
            local = host_local_batch(ids, mesh).to(device)
            model(local)  # warm
            _sync(device)
            for _ in range(reps):
                t0 = time.perf_counter()
                model(local)
                _sync(device)
                best = min(best, time.perf_counter() - t0)
        del model
    times = [None] * dist.get_world_size()
    dist.all_gather_object(times, best if best < float("inf") else None)
    slowest = max(t for t in times[:dp * tp])
    return dict(dp=dp, tp=tp, seconds=slowest, tokens_per_s=batch * dp * seq / slowest)


def run_shapes(shapes: Sequence[Tuple[int, int]], cfg, device, **kw) -> List[dict]:
    """Every shape in turn inside the current process group (the same list
    on every rank); the efficiency against the first shape's per-rank
    throughput."""
    out = [measure(s, cfg, device, **kw) for s in shapes]
    if out:
        base = out[0]["tokens_per_s"] / (out[0]["dp"] * out[0]["tp"])
        for r in out:
            r["efficiency"] = r["tokens_per_s"] / (base * r["dp"] * r["tp"])
    return out


def _rank(rank: int, world: int, store: str, args, shapes) -> None:
    import torch.distributed as dist

    device = torch.device(args.device if args.device == "cpu"
                          else f"cuda:{rank % torch.cuda.device_count()}")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(args.backend, store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        cfg = config(device)
        res = run_shapes(shapes, cfg, device)
        if rank == 0:
            print(json.dumps({"hidden_size": cfg.hidden_size,
                              "layers": cfg.num_hidden_layers, "backend": args.backend,
                              "device": str(device), "world": world, "shapes": res}), flush=True)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    import torch.multiprocessing as mp

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, default=None)
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("scaling_bench: no CUDA device (pass --device cpu)", file=sys.stderr)
        return 2
    world = args.world or (torch.cuda.device_count() if args.device == "cuda" else 1) or 1
    args.backend = args.backend or ("nccl" if args.device == "cuda" else "gloo")
    shapes = [s for s in SHAPES if s[0] * s[1] <= world]
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_rank, args=(world, os.path.join(tmp, "store"), args, shapes),
                           nprocs=world, join=True, start_method="spawn")
    return 0


if __name__ == "__main__":
    sys.exit(main())
