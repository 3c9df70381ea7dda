"""What INITIAL_PROCESSING should have produced by the window's end, from
the survey's truth.

* Load: every image of the batches loaded so far is a node (``missing``), at
  its geotag's local position (``position_m``, the largest error in metres)
  with the tag's focal (``focal_px``).
* Link: each edge holds four decomposed relative rotations; the relax
  uses the one nearest its poses, so an edge's error is its nearest
  candidate's angle to the truth (``edge_deg``: the largest over edges with
  ``min_inliers`` or more, ``edge_deg_median`` over all). ``link_share`` is
  the share of neighbours along a flight line, both relaxed, that an edge
  joins.
* Relax: each relaxed camera's orientation against the truth
  (``orientation_deg``: the largest, ``orientation_deg_median``), and how far
  its quaternion's norm is from 1 (``quat_norm_gap``): a rotation's
  quaternion is a unit one, and float64 keeps it so to rounding.
* ``edges`` and ``relaxed``: how many edges the graph holds and how many
  images were relaxed, for the record; on a fixed survey they repeat.
"""

from __future__ import annotations

import numpy as np

from ocbench.reference.geometry import angle_deg, relative


def compare(answers: dict, config: dict, traffic: dict, seed: int) -> dict:
    truth = answers["truth"]
    nodes, edges, relaxed = answers["nodes"], answers["edges"], answers["relaxed"]
    spec = config["survey"]
    local = truth.local_positions()
    due = min(len(truth.paths), answers["batches"] * config["pipeline"]["batch_size"])
    present = [k for k in range(due) if k in nodes]
    out = {"missing": float(due - len(present))}
    out["position_m"] = max((float(np.abs(nodes[k]["position"] - local[k]).max()) for k in present), default=np.inf)
    tag = spec["focal_px"] * spec.get("focal_tag_scale", 1.0)
    out["focal_px"] = max((abs(nodes[k]["focal"] - tag) for k in present), default=np.inf)

    errs, counts = [], []
    for e in edges:
        want = relative(truth.quats[e["a"]], truth.quats[e["b"]])
        errs.append(float(angle_deg(e["quats"], want[None]).min()))
        counts.append(e["inliers"])
    errs, counts = np.asarray(errs), np.asarray(counts)
    strong = errs[counts >= traffic["min_inliers"]]
    out["edge_deg"] = float(strong.max()) if len(strong) else np.inf
    out["edge_deg_median"] = float(np.median(errs)) if len(errs) else np.inf
    out["edges"] = float(len(edges))
    out["relaxed"] = float(len(relaxed))

    linked = {(e["a"], e["b"]) for e in edges} | {(e["b"], e["a"]) for e in edges}
    rel = set(relaxed)
    index = truth.index
    along = [(a, b) for a in rel for b in rel
             if a < b and index[a, 0] == index[b, 0] and abs(index[a, 1] - index[b, 1]) == 1]
    out["link_share"] = sum((a, b) in linked for a, b in along) / len(along) if along else 0.0

    if relaxed:
        q = np.stack([nodes[k]["orientation"] for k in relaxed])
        err = angle_deg(q, truth.quats[relaxed])
        out["orientation_deg"] = float(np.nanmax(err)) if np.isfinite(err).all() else np.inf
        out["orientation_deg_median"] = float(np.median(err))
        out["quat_norm_gap"] = float(np.abs(np.linalg.norm(q, axis=1) - 1.0).max())
    else:
        out["orientation_deg"] = out["orientation_deg_median"] = out["quat_norm_gap"] = np.inf
    return out
