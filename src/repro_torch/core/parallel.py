"""ParallelContext -- the simulated mesh the distributed embedding bag runs
over.

The counterpart of ``repro.core.parallel`` for the DLRM path.  The
reference's context wraps a jax ``Mesh``: its last axis is the model (tp)
axis the tables are sharded over, the others are data (dp) axes the batch
is split over.  Here the mesh is simulated in one process on one device:

  * the model axis has ``tp_size`` ranks, stacked on a leading rank axis
    (``core/comm.py``);
  * ``dp_size`` data-parallel groups split the batch and run one after
    another, each over the whole model axis.

Models take ``ctx: ParallelContext | None``; ``None`` is the single-device
path.  The reference's ``ShardingConfig`` and LM helpers are not part of
this slice.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ParallelContext:
    tp_size: int                        # ranks of the model axis
    dp_size: int = 1                    # data-parallel groups

    def __post_init__(self):
        if self.tp_size < 1 or self.dp_size < 1:
            raise ValueError(f"tp_size and dp_size must be >= 1, got "
                             f"{self.tp_size} and {self.dp_size}")

    @property
    def dp_axes(self) -> Tuple[str, ...]:
        """The data axis, when there is one (``dp_size > 1``)."""
        return ("data",) if self.dp_size > 1 else ()

    def dp_for(self, dim: int) -> Optional[Tuple[str, ...]]:
        """The dp axes usable to shard a dim of this size (divisibility);
        None when the dim stays replicated over the data axis."""
        if self.dp_axes and dim % self.dp_size == 0:
            return self.dp_axes
        return None

    def dp_groups(self, dim: int) -> int:
        """How many groups a batch of ``dim`` rows is split into: ``dp_size``
        when it divides, else 1 (every group would score the same replicated
        batch)."""
        return self.dp_size if self.dp_for(dim) else 1


def make_context(tp_size: int, dp_size: int = 1) -> ParallelContext:
    """A simulated ``(dp_size, tp_size)`` mesh: the last axis is the model
    axis, the data axis exists when ``dp_size > 1`` -- as the reference's
    ``make_context`` infers the axes of a ``("data", "model")`` or a
    ``("model",)`` mesh."""
    return ParallelContext(tp_size=tp_size, dp_size=dp_size)
