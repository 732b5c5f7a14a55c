"""What the client side knows of one request."""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional


@dataclasses.dataclass
class Record:
    i: int                       # request index in the seed's stream
    intended: float              # when it was due to be sent (perf_counter)
    sent: float = math.nan
    done: float = math.nan       # when its answer reached the client
    completion: Any = None       # the engine's Completion
    error: Optional[str] = None  # refused at submit, or an error answer

    @property
    def ok(self) -> bool:
        return self.completion is not None and self.error is None

    @property
    def latency_s(self) -> float:
        """From the intended send time; inf for a failed request."""
        return self.done - self.intended if self.ok else math.inf
