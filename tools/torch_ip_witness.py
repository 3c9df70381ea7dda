"""INITIAL_PROCESSING of chip_smoke.py's phase-7 survey (``chip_smoke.MULTI``:
7 x 8 flat images at 1600 x 1200, 12 m apart) in the port and in the JAX
package from the same extracted features, to tell whether a camera that the
port's INITIAL_PROCESSING leaves far off is the reference's behaviour too.

``capture OUT`` (needs a CUDA device) renders the survey on the card, runs
the port's INITIAL_PROCESSING with the pipeline's defaults, prints every
placed camera's orientation error after each ``iterate_once``, and writes
every image's node as the load stage made it (metadata, features) with the
ground truth to ``OUT/nodes.pkl.gz``. It then replays INITIAL_PROCESSING on
the card from those nodes (the load stage's decode and extraction replaced
by the captured nodes), which must give the same result::

    python tools/torch_ip_witness.py capture chiprun_out/witness

``replay OUT`` runs INITIAL_PROCESSING from the captured nodes on the CPU,
four ways: the port with its default RANSAC draw (the draw of the capture),
the JAX package with its own draw, the port with the JAX package's draw and
the JAX package with the port's. It prints the same per-pass errors for
each, and after the first run where the card's graph and the CPU's part,
pass by pass. The JAX package runs in float64 on its CPU backend, as its
tests do; this mode imports it::

    python tools/torch_ip_witness.py replay chiprun_out/witness
"""

from __future__ import annotations

import argparse
import copy
import gzip
import os
import pickle
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

HYPOTHESES, MIN_POINTS, JAX_SEED = 2048, 4, 42


def _angles_deg(quats, quats_gt):
    from opencalibration_tpu_torch.ops.quaternion import quat_angle, quat_conjugate, quat_multiply
    import torch

    a = torch.as_tensor(np.asarray(quats, np.float64))
    b = torch.as_tensor(np.asarray(quats_gt, np.float64))
    return np.degrees(quat_angle(quat_multiply(a, quat_conjugate(b))).numpy())


def _errors(p, paths, quats_gt):
    """{image index: orientation error in degrees} of the placed cameras
    (those with an orientation: a batch has one from its relax on)."""
    by_path = {n.payload.path: n.payload for _, n in p.graph.nodes()}
    idx = [i for i, path in enumerate(paths)
           if path in by_path and np.isfinite(np.asarray(by_path[path].orientation)).all()]
    if not idx:
        return {}
    err = _angles_deg([by_path[paths[i]].orientation for i in idx], [quats_gt[i] for i in idx])
    return dict(zip(idx, err.tolist()))


def _report(label, p, paths, quats_gt, pass_no):
    err = _errors(p, paths, quats_gt)
    if not err:
        print(f"[{label}] pass {pass_no}: no camera placed", flush=True)
        return err
    vals = np.asarray(list(err.values()))
    worst = max(err, key=err.get)
    far = {i: round(e, 4) for i, e in err.items() if e > 5.0}
    print(f"[{label}] pass {pass_no}: {len(err)} of {p.graph.size_nodes()} cameras placed, "
          f"{p.graph.size_edges()} edges, median "
          f"{np.median(vals):.4f} deg, max {vals.max():.4f} deg at image {worst}; over 5 deg: {far}", flush=True)
    return err


def _snapshot(p, paths):
    """The graph after a pass, by image index: each node's orientation and
    position, each edge's inlier count, relation type and scored relative
    poses."""
    index = {path: i for i, path in enumerate(paths)}
    of = lambda nid: index[p.graph.get_node(nid).payload.path]  # noqa: E731
    nodes = {index[n.payload.path]: (np.array(n.payload.orientation, np.float64),
                                     np.array(n.payload.position, np.float64)) for _, n in p.graph.nodes()}
    edges = {(of(e.source), of(e.dest)): (len(e.payload.inlier_idx1), str(e.payload.relation_type),
                                          np.array(e.payload.rel_quats, np.float64),
                                          np.array(e.payload.rel_scores, np.float64))
             for _, e in p.graph.edges()}
    return dict(nodes=nodes, edges=edges)


def _run(label, pipeline, paths, quats_gt):
    """INITIAL_PROCESSING of ``paths``; returns the final errors and the
    graph after every pass."""
    pipeline.add(paths)
    n, t0, trace = 0, time.perf_counter(), []
    while pipeline.get_state() == "INITIAL_PROCESSING":
        pipeline.iterate_once()
        _report(label, pipeline, paths, quats_gt, n)
        trace.append(_snapshot(pipeline, paths))
        n += 1
    err = _report(label, pipeline, paths, quats_gt, "end")
    print(f"[{label}] INITIAL_PROCESSING in {time.perf_counter() - t0:.1f} s", flush=True)
    return err, trace


def _compare(label, a, b, rad=1e-6):
    """Where two runs' graphs part, pass by pass: edges present in one
    only, edges whose inlier count, relation type or best relative pose
    differ (by more than ``rad``), nodes whose orientation differs."""
    for k, (sa, sb) in enumerate(zip(a, b)):
        ea, eb = sa["edges"], sb["edges"]
        only = sorted(set(ea) ^ set(eb))
        edge_diff = []
        for key in sorted(set(ea) & set(eb)):
            (na, ta, qa, ca), (nb, tb, qb, cb) = ea[key], eb[key]
            gap = float(np.radians(_angles_deg(qa[:1], qb[:1]).max())) if np.isfinite(qa[0]).all() else 0.0
            if na != nb or ta != tb or not gap <= rad:
                edge_diff.append((key, na, nb, ta, tb, round(gap, 6), np.round(ca, 4).tolist(), np.round(cb, 4).tolist()))
        node_diff = {}
        for i in sorted(set(sa["nodes"]) & set(sb["nodes"])):
            qa, qb = sa["nodes"][i][0], sb["nodes"][i][0]
            if np.isfinite(qa).all() != np.isfinite(qb).all():
                node_diff[i] = "placed in one run only"
            elif np.isfinite(qa).all():
                gap = float(np.radians(_angles_deg(qa, qb)))
                if gap > rad:
                    node_diff[i] = f"{gap:.3e} rad"
        print(f"[{label}] pass {k}: edges in one run only {only}; {len(edge_diff)} edges differ; nodes differ "
              f"{node_diff}", flush=True)
        for d in edge_diff:
            print(f"[{label}]   edge {d[0]}: inliers {d[1]} / {d[2]}, type {d[3]} / {d[4]}, best poses "
                  f"{d[5]} rad apart, scores {d[6]} / {d[7]}", flush=True)


class _Inject:
    """The load stage of ``stages`` (either package's) hands out the
    captured nodes of its batch's paths instead of decoding and extracting;
    ``convert`` turns a captured (port) node into that package's node."""

    def __init__(self, stages, nodes, convert=copy.deepcopy):
        self.stages, self.nodes, self.convert = stages, nodes, convert
        self._orig = (stages.LoadStage.start_decode, stages.LoadStage.finish)

    def __enter__(self):
        nodes, convert = self.nodes, self.convert

        def start_decode(stage, parallelism=8):
            return None

        def finish(stage):
            stage._decoded = [SimpleNamespace(node=convert(nodes[p])) for p in stage._paths]

        self.stages.LoadStage.start_decode, self.stages.LoadStage.finish = start_decode, finish
        return self

    def __exit__(self, *exc):
        self.stages.LoadStage.start_decode, self.stages.LoadStage.finish = self._orig


def capture(out):
    import torch

    import chip_smoke as CS
    from opencalibration_tpu_torch.pipeline import stages as ST
    from opencalibration_tpu_torch.pipeline.pipeline import Pipeline
    from opencalibration_tpu_torch.testing import survey as S

    print(f"[witness] {torch.cuda.get_device_name(0)}", flush=True)
    cfg = CS.MULTI
    nodes = {}
    finish = ST.LoadStage.finish

    def recording(stage):
        finish(stage)
        for d in stage._decoded:
            if d is not None:
                nodes[d.node.path] = copy.deepcopy(d.node)

    with tempfile.TemporaryDirectory() as d:
        paths, positions, quats_gt = S.write_survey(
            d, cfg["rows"], cfg["cols"], spacing=CS.SPACING, width=cfg["width"], height=cfg["height"],
            focal=cfg["focal"], texture=cfg["texture"], relief_amplitude=0.0,
            relief_wavelength=CS.RELIEF_WAVELENGTH_M, device="cuda")
        ST.LoadStage.finish = recording
        try:
            captured, trace = _run("card", Pipeline(device="cuda"), paths, quats_gt)
        finally:
            ST.LoadStage.finish = finish
    with _Inject(ST, nodes):
        replayed, _ = _run("card replay", Pipeline(device="cuda"), paths, quats_gt)
    same = captured == replayed
    print(f"[witness] replay from the captured nodes on the card equals the capture: {same}", flush=True)
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, "nodes.pkl.gz")
    with gzip.open(path, "wb") as f:
        pickle.dump(dict(paths=paths, nodes=nodes, positions=np.asarray(positions), quats_gt=np.asarray(quats_gt),
                         card_errors=captured, card_trace=trace, device=torch.cuda.get_device_name(0)), f)
    print(f"[witness] wrote {path}: {os.path.getsize(path) / 2**20:.2f} MiB", flush=True)
    return 0 if same else 1


def _jax_cpu():
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    return jax


def replay(out):
    import torch

    from opencalibration_tpu_torch import interop
    from opencalibration_tpu_torch.ops import ransac as R
    from opencalibration_tpu_torch.pipeline import stages as ST
    from opencalibration_tpu_torch.pipeline.pipeline import Pipeline

    with gzip.open(os.path.join(out, "nodes.pkl.gz"), "rb") as f:
        cap = pickle.load(f)
    paths, nodes, quats_gt = cap["paths"], cap["nodes"], cap["quats_gt"]
    print(f"[witness] {len(nodes)} captured nodes ({cap['device']}); the capture's final errors over 5 deg: "
          f"{ {i: round(e, 4) for i, e in cap['card_errors'].items() if e > 5.0} }", flush=True)
    results = {}
    with _Inject(ST, nodes):
        results["port cpu, port draw"], trace = _run("port cpu, port draw", Pipeline(device="cpu"), paths, quats_gt)
    _compare("card against cpu", cap["card_trace"], trace)

    jax = _jax_cpu()
    from opencalibration_tpu.pipeline import stages as JST
    from opencalibration_tpu.pipeline.pipeline import Pipeline as JPipeline
    from opencalibration_tpu.types import graph as JG

    convert = lambda n: interop.image_node_from(n, types=JG)  # noqa: E731
    with _Inject(JST, nodes, convert):
        results["jax, jax draw"], _ = _run("jax, jax draw", JPipeline(), paths, quats_gt)
    jax_u = torch.from_numpy(np.array(jax.random.uniform(jax.random.PRNGKey(JAX_SEED), (HYPOTHESES, MIN_POINTS))))
    with _Inject(ST, nodes):
        results["port cpu, jax draw"], _ = _run("port cpu, jax draw",
                                                Pipeline(device="cpu", ransac_uniforms=jax_u), paths, quats_gt)
    port_u = R.default_uniforms(HYPOTHESES, MIN_POINTS, R.DEFAULT_SEED, "cpu").numpy()
    uniform = jax.random.uniform

    def drawn(key, shape=(), *a, **kw):
        if tuple(shape) == (HYPOTHESES, MIN_POINTS):
            return jax.numpy.asarray(port_u)
        return uniform(key, shape, *a, **kw)

    jax.random.uniform = drawn
    jax.clear_caches()  # the link program was traced with the JAX package's own draw
    try:
        with _Inject(JST, nodes, convert):
            results["jax, port draw"], _ = _run("jax, port draw", JPipeline(), paths, quats_gt)
    finally:
        jax.random.uniform = uniform
    print("[witness] final orientation errors over 5 deg, by run:", flush=True)
    for label, err in results.items():
        vals = np.asarray(list(err.values()))
        print(f"[witness]   {label}: median {np.median(vals):.4f} deg, max {vals.max():.4f} deg; "
              f"{ {i: round(e, 4) for i, e in err.items() if e > 5.0} }", flush=True)
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("mode", choices=("capture", "replay"))
    ap.add_argument("out")
    args = ap.parse_args(argv)
    return capture(args.out) if args.mode == "capture" else replay(args.out)


if __name__ == "__main__":
    sys.exit(main())
