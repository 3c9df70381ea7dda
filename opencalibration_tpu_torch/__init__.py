"""PyTorch + CUDA port of opencalibration_tpu.

The package mirrors the JAX package's subpackage and module names, so every
module's twin sits at the same relative path. It imports ``torch`` and never
``jax``, and nothing of the JAX package: the framework-neutral host modules
it needs (``types/graph.py``, ``geo/geo_coord.py``, ``native``,
``extract/metadata.py``, ``extract/camera_database.py``, ``surface/mesh.py``,
``surface/refine.py``, ``ops/clustering.py``, ``utils/performance.py``) are
copies of the JAX package's own. The JAX package stays the reference, and
only the parity tests import both.

Conventions kept at public functions, so a caller can compare like with like:
pixel coordinates are (x = col, y = row), quaternions are (w, x, y, z), and
binary descriptors are 16 packed 32-bit words per 486-bit descriptor. Torch
has no usable ``uint32`` arithmetic, so the words travel as ``int32`` tensors
holding the same bit patterns (``interop`` converts at the boundary).

The entry points (``apps/pipeline_runner.py`` and ``apps/extract_camera_db.py``
with ``--device``, ``Pipeline`` and its stages) run on the card unless the
caller asks for the CPU; every function that creates tensors from
nothing takes an explicit ``device``; work on a CUDA tensor never falls back
to the CPU.
"""
