"""Integer-time simulation timeline with power-of-two step adjustment.

A copy of ``cmacionize_tpu/utils/timeline.py`` (pure Python), so that the
port imports no JAX.  The simulation interval is mapped onto integer ticks;
the step size only ever doubles or halves (clamped to [min, max]) so that
snapshot times are hit exactly and step sizes stay reproducible.
"""

from __future__ import annotations


class TimeLine:
    """Maps [t_begin, t_end] onto 2^62 integer ticks."""

    TOTAL_TICKS = 1 << 62

    def __init__(
        self,
        t_begin: float,
        t_end: float,
        minimum_timestep: float,
        maximum_timestep: float,
    ):
        self._t_begin = t_begin
        self._t_end = t_end
        span = t_end - t_begin
        self._tick = span / self.TOTAL_TICKS
        self._current = 0

        def pow2_ticks(dt: float) -> int:
            ticks = max(int(dt / self._tick), 1)
            power = 1
            while power * 2 <= ticks:
                power *= 2
            return power

        self._min_ticks = pow2_ticks(minimum_timestep)
        self._max_ticks = pow2_ticks(min(maximum_timestep, span))
        self._step_ticks = self._max_ticks

    @property
    def current_time(self) -> float:
        return self._t_begin + self._current * self._tick

    def restore(self, time: float) -> None:
        """Re-enter the timeline mid-stream (restart resume)."""
        self._current = min(
            int(round((time - self._t_begin) / self._tick)), self.TOTAL_TICKS
        )
        remaining = self.TOTAL_TICKS - self._current
        if 0 < remaining < self._step_ticks:
            self._step_ticks = remaining

    @property
    def current_timestep(self) -> float:
        return self._step_ticks * self._tick

    def set_timestep(self, desired_dt: float) -> float:
        """Adjust the step: halve while too large, double while it fits and
        divides the remaining ticks."""
        while (
            self._step_ticks * self._tick > desired_dt
            and self._step_ticks > self._min_ticks
        ):
            self._step_ticks //= 2
        while (
            self._step_ticks * 2 * self._tick <= desired_dt
            and self._step_ticks * 2 <= self._max_ticks
            and self._current % (self._step_ticks * 2) == 0
        ):
            self._step_ticks *= 2
        return self.current_timestep

    def advance(self) -> bool:
        """Advance one step; returns True while the end is not reached."""
        self._current += self._step_ticks
        remaining = self.TOTAL_TICKS - self._current
        if remaining <= 0:
            return False
        if remaining < self._step_ticks:
            self._step_ticks = remaining
        return True

    @property
    def finished(self) -> bool:
        return self._current >= self.TOTAL_TICKS
