"""What a calibration job should have produced, from the survey's truth;
each number is the worst over the window's completed jobs.

* ``missing``: images of the block that are not in the job's graph.
* ``position_m``: the largest camera position error (the geotags are exact).
* ``orientation_deg`` / ``orientation_deg_median``: camera orientations
  against the truth; ``quat_norm_gap``: how far a quaternion's norm is from
  1, which float64 keeps to rounding.
* ``focal_px`` / ``principal_px``: the camera model against the calibrated
  camera the tags state (the configuration holds the intrinsics fixed).
* ``surface_m``: the largest error of the mesh's height under each camera,
  against the ground.
"""

from __future__ import annotations

import numpy as np

from ocbench.reference.geometry import angle_deg, mesh_height, relief_height

NUMBERS = ("missing", "position_m", "orientation_deg", "orientation_deg_median", "quat_norm_gap", "focal_px",
           "principal_px", "surface_m")


def _job(ans: dict, truth, spec: dict) -> dict:
    nodes = ans["nodes"]
    ks = [k for k in range(len(truth.paths)) if k in nodes]
    if not ks:
        return dict({key: np.inf for key in NUMBERS}, missing=float(len(truth.paths)))
    out = {"missing": float(len(truth.paths) - len(ks))}
    local = truth.local_positions()
    out["position_m"] = max(float(np.abs(nodes[k]["position"] - local[k]).max()) for k in ks)
    q = np.stack([nodes[k]["orientation"] for k in ks])
    err = angle_deg(q, truth.quats[ks])
    out["orientation_deg"] = float(err.max()) if np.isfinite(err).all() else np.inf
    out["orientation_deg_median"] = float(np.median(err))
    out["quat_norm_gap"] = float(np.abs(np.linalg.norm(q, axis=1) - 1.0).max())
    tag = spec["focal_px"] * spec.get("focal_tag_scale", 1.0)
    out["focal_px"] = max(abs(nodes[k]["focal"] - tag) for k in ks)
    centre = np.array([spec["width"] / 2.0, spec["height"] / 2.0])
    out["principal_px"] = max(float(np.abs(nodes[k]["principal"] - centre).max()) for k in ks)
    mesh = ans["mesh"]
    if mesh is None:
        out["surface_m"] = np.inf
        return out
    z = mesh_height(mesh[0], mesh[1], local[ks, :2])
    ground = relief_height(truth.positions[ks, :2], spec.get("relief_amplitude_m", 0.0),
                           spec.get("relief_wavelength_m", 70.0))
    dz = np.abs(z - ground)
    out["surface_m"] = float(dz.max()) if np.isfinite(dz).all() else np.inf
    return out


def compare(answers: dict, config: dict, traffic: dict, seed: int) -> dict:
    per_job = [_job(ans, answers["truth"], config["survey"]) for ans in answers["jobs"]]
    return {key: max(job[key] for job in per_job) for key in NUMBERS}
