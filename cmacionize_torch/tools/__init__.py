"""Counterparts of the repository's ``tools/`` modules that hold Pallas kernels.

The names mirror ``tools/``: ``experimental_emission_octa`` (the stratified,
octant-pure emission the cone march needs), ``experimental_cone_kernel`` (the
cone-marched traversal, K10) and ``microbench_scatter`` (the scatter and
gather microbenchmark with the two gathers K11 and K11r).  Each keeps its own
copy of what it needs and imports nothing of ``tools/`` or the JAX package.
"""
