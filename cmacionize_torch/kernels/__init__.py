"""Hand-written CUDA kernels: loader, wrappers and launch counts.

``LAUNCHES[name]`` is incremented by a kernel's wrapper each time it launches
the kernel, and nowhere else, so a run can show that its main path went
through the kernel (``LAUNCHES.clear()`` resets the counts).
"""

from __future__ import annotations

import collections

LAUNCHES: collections.Counter = collections.Counter()
