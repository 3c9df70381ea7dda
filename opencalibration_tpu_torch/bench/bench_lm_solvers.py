"""The LM's two linear solvers on the card by tangent dimension (twin of the
repository's bench_lm_solvers.py): dense Cholesky against matrix-free
Jacobi-PCG on synthetic ground-mesh problems, T = 3C + V + 8 (the global
ground-mesh relax's shape; the reference solves these with Ceres
SPARSE_SCHUR / ITERATIVE_SCHUR). Prints ms per LM iteration of each solver,
the measurement behind ``lm.CG_DIM_THRESHOLD``::

    python -m opencalibration_tpu_torch.bench.bench_lm_solvers [--device cuda|cpu] [C,Vgrid,NB ...]
    BENCH_SOLVERS=cg python -m opencalibration_tpu_torch.bench.bench_lm_solvers 1000,4096,32768

The first line is the device (the card's name and power limit); then per
configuration the original's lines: the problem, and per solver the warm
solve (``init_lambda=0.9999``) in seconds, ms an iteration and iterations,
the cold solve's seconds and the final cost. Each solve is timed on the host
clock with the device synchronised before both readings. The original runs
on the CPU unless ``BENCH_PLAT`` says otherwise; this twin runs on the card
unless ``--device cpu`` says otherwise.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from opencalibration_tpu_torch.bench import bench_e2e
from opencalibration_tpu_torch.relax import blocks as B
from opencalibration_tpu_torch.relax import lm
from opencalibration_tpu_torch.relax.tangent import RelaxParams, TangentLayout
from opencalibration_tpu_torch.utils.device import resolve_device

CONFIGS = ("150,400,4096", "512,1024,8192", "1000,1600,16384")
SOLVERS = ("cholesky", "cg")


def make_big_mesh_problem(C, Vg, NB, seed=0, *, device="cuda"):
    """Synthetic ground-mesh problem: C cameras over a sqrt(Vg) grid, NB
    plane-ray track blocks in pixel form, anchors and downward priors;
    float32, the original's draws in its order. Returns (params, (plane-ray,
    anchor, prior), layout, free mask)."""
    dev = torch.device(device)
    f32 = torch.float32
    rng = np.random.default_rng(seed)
    side = int(np.sqrt(Vg))
    V = side * side
    layout = TangentLayout(C, V, 0, 1)
    quats = np.tile(np.array([0.0, 1.0, 0.0, 0.0]), (C, 1))
    quats += rng.normal(0, 0.01, size=(C, 4))
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    positions = np.stack([
        rng.uniform(0, side * 10.0, C), rng.uniform(0, side * 10.0, C),
        np.full(C, 30.0)
    ], 1)
    params = RelaxParams(
        quats=torch.as_tensor(quats, dtype=f32, device=dev),
        positions=torch.as_tensor(positions, dtype=f32, device=dev),
        mesh_z=torch.zeros(V, dtype=f32, device=dev),
        points=torch.zeros((0, 3), dtype=f32, device=dev),
        focal=torch.full((1,), 600.0, dtype=f32, device=dev),
        principal=torch.tensor([[400.0, 300.0]], dtype=f32, device=dev),
        radial=torch.zeros((1, 3), dtype=f32, device=dev),
        tangential=torch.zeros((1, 2), dtype=f32, device=dev),
    )
    # random triangles on the grid
    r = rng.integers(0, side - 1, NB)
    c = rng.integers(0, side - 1, NB)
    i00 = r * side + c
    vert_idx = np.stack([i00, i00 + 1, i00 + side], 1)
    xy = np.stack([
        np.stack([c * 10.0, r * 10.0], 1),
        np.stack([(c + 1) * 10.0, r * 10.0], 1),
        np.stack([c * 10.0, (r + 1) * 10.0], 1),
    ], 1)
    cam_idx = rng.integers(0, C, (NB, 5))
    ray_valid = np.zeros((NB, 5), bool)
    ray_valid[:, :3] = True
    pixel = np.array([400.0, 300.0]) + rng.normal(0, 60.0, (NB, 5, 2))

    def i64(x):
        return torch.as_tensor(x, dtype=torch.int64, device=dev)

    blk = B.plane_ray_block(
        layout, i64(vert_idx), torch.as_tensor(xy, dtype=f32, device=dev),
        i64(cam_idx), torch.as_tensor(ray_valid, device=dev),
        torch.ones(NB, dtype=f32, device=dev), model_i=torch.zeros(NB, dtype=torch.int64, device=dev),
        pixel=torch.as_tensor(pixel, dtype=f32, device=dev),
    )
    anchor = B.mesh_anchor_block(
        layout, torch.arange(V, device=dev), torch.zeros(V, dtype=f32, device=dev),
        torch.ones(V, dtype=f32, device=dev),
    )
    down = B.downwards_prior_block(layout, torch.arange(C, device=dev), torch.ones(C, dtype=f32, device=dev))
    free = layout.build_free_mask(mesh_free=True, focal_free=True, device=dev)
    return params, (blk, anchor, down), layout, free


def bench(C, Vg, NB, iters=10, solvers=SOLVERS, *, device="cuda"):
    """The original's lines for one configuration; returns per solver
    (warm s, ms an iteration, iterations, cold s, final cost), or the
    exception's text where a solver failed."""
    dev = torch.device(device)
    params, blocks, layout, free = make_big_mesh_problem(C, Vg, NB, device=dev)
    print(f"C={C} V={layout.V} NB={NB} T={layout.dim}", flush=True)
    out = {}
    for s in solvers:
        try:
            bench_e2e._sync(dev)
            t0 = time.perf_counter()
            solved, info = lm.solve(params, blocks, layout, free, max_iterations=iters, linear_solver=s)
            bench_e2e._sync(dev)
            t_cold = time.perf_counter() - t0
            t0 = time.perf_counter()
            solved, info = lm.solve(params, blocks, layout, free, max_iterations=iters, linear_solver=s,
                                    init_lambda=0.9999)
            bench_e2e._sync(dev)
            t = time.perf_counter() - t0
            it = int(info.iterations)
            cost = float(info.final_cost)
            print(
                f"  {s:9s}: warm {t:7.2f}s ({t/max(it,1)*1e3:8.1f} ms/it,"
                f" {it} its) cold {t_cold:.2f}s cost->"
                f"{cost:.4f}", flush=True,
            )
            out[s] = dict(warm_s=t, ms_per_iteration=t / max(it, 1) * 1e3, iterations=it, cold_s=t_cold,
                          final_cost=cost, T=layout.dim)
        except Exception as e:
            print(f"  {s}: FAILED {type(e).__name__}: {e}", flush=True)
            out[s] = f"{type(e).__name__}: {e}"
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("configs", nargs="*", help="C,Vgrid,NB (default: " + " ".join(CONFIGS) + ")")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(bench_e2e.device_line(dev), flush=True)
    solvers = tuple(os.environ.get("BENCH_SOLVERS", ",".join(SOLVERS)).split(","))
    for cfg in args.configs or CONFIGS:
        C, Vg, NB = map(int, cfg.split(","))
        bench(C, Vg, NB, solvers=solvers, device=dev)


if __name__ == "__main__":
    main()
