"""Armed interval: a ticker that fires once per arming.

Async analog of the reference's Interval (interval.go:24-67): the timer only
runs after `arm()` is called (when a batch opens), so an idle queue costs no
timer wakeups.  All three batching loops use it (the reference wires it into
peers.go:144 and global.go:73,159).
"""

from __future__ import annotations

import asyncio
from typing import Optional


class ArmedInterval:
    def __init__(self, delay: float):
        self.delay = delay
        self.fired = asyncio.Event()
        self._task: Optional[asyncio.Task] = None

    def arm(self) -> None:
        """Schedule one tick `delay` from now; re-arming while pending is a
        no-op (reference interval.go:62-67)."""
        if self._task is None or self._task.done():
            self.fired.clear()
            self._task = asyncio.create_task(self._run())

    async def _run(self) -> None:
        await asyncio.sleep(self.delay)
        self.fired.set()

    async def wait(self) -> None:
        await self.fired.wait()

    def stop(self) -> None:
        if self._task is not None and not self._task.done():
            self._task.cancel()
