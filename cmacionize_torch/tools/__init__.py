"""Counterparts of the repository's ``tools/`` modules that hold Pallas kernels.

The names mirror ``tools/``: ``experimental_emission_octa`` (the stratified,
octant-pure emission the cone march needs), ``experimental_cone_kernel`` (the
cone-marched traversal, K10), ``microbench_scatter`` (the scatter and
gather microbenchmark with the two gathers K11 and K11r),
``probe_pallas_gather`` (the dynamic-indexing probes: K12t, K12r, K12s, K12a
and K11r), ``probe_deposit`` and ``probe_deposit2`` (the in-kernel deposit
formulations D2-D8b, all the shifted histogram K13h, and the DDA-step probes
E, K13e, and W2, K13w, with D12's fill, K13f) and ``probe_cohort_kernel``
(the cohort traversal's mechanics: the counted grid K14a, the lane-gather
loop K14b, the row stream K14c and D's deposit on K13h).  Each keeps its own
copy of what it needs and imports nothing of ``tools/`` or the JAX package.
"""
