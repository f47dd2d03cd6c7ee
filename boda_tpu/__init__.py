"""boda_tpu: a JAX framework with the capabilities of moskewcz/boda.

Where the reference (see /root/reference, SURVEY.md) generated CUDA/OpenCL at
runtime from CUCL templates, this framework is JAX-first: Pallas kernel
templates emit MXU-tiled conv/SGEMM variants selected and blocked per op
signature; a compute-graph executor imports Caffe nets and lowers them to
jitted XLA programs; an ops-prof-style autotuner persists per-platform
"wisdom" records; and a digest-based golden test harness pins numerics.
"""

__version__ = "0.1.0"
