"""Multi-device cold-plane worker: one drained batch, every card.

The counterpart of the reference's MeshWorker (sieve/backends/mesh_backend.py)
with its ``_make_cold_step`` (sieve/parallel/mesh.py). ``process_segments``
keeps TorchWorker's host prepare and shape grouping, so results equal the
loop path by construction; per shape group the batch is padded onto the
devices and each device runs ``mark_words_batch`` on its rows:

- the batch is padded to ``ndev * next_pow2(ceil(B / ndev))`` rows, so
  every device holds the same, power-of-two number of rows;
- pad rows copy the group's first member: they compute a real result
  that is dropped, so padding cannot touch the live rows;
- the rows are cut into ``ndev`` contiguous slices, one per device
  (``shard_devices``), and the results come back in batch order.

The slices are queued on every device before any result is read, so the
cards work at once. Construction raises when fewer devices than asked are
there, as the reference's ``build_mesh`` does.
"""

from __future__ import annotations

import numpy as np
import torch

from sieve_torch import env, trace
from sieve_torch.backends.torch_words import TorchWorker, stack_tables
from sieve_torch.kernels.pairs import pair_kind
from sieve_torch.kernels.specs import TieredSegment
from sieve_torch.kernels.word_mark import mark_words_batch, next_pow2
from sieve_torch.parallel.mesh import shard_devices


def mesh_device_count(device: str = "cuda") -> int:
    """Devices the cold mesh spans: ``SIEVE_MESH_COLD_DEVICES``, else every
    card torch sees for a CUDA device, else 1."""
    want = env.env_int("SIEVE_MESH_COLD_DEVICES", 0)
    if want > 0:
        return want
    if torch.device(device).type == "cuda" and torch.cuda.is_available():
        return max(1, torch.cuda.device_count())
    return 1


def _rows(tables: tuple, a: int, b: int) -> tuple:
    """Rows [a, b) of every batched table (patterns are a nested tuple)."""
    return tuple(_rows(t, a, b) if isinstance(t, tuple) else t[a:b]
                 for t in tables)


class MeshWorker(TorchWorker):
    """Cold-plane worker: ``process_segments`` shards each shape group's
    batch over the devices (one launch per group)."""

    name = "mesh"

    def __init__(self, config, n_devices: int | None = None):
        super().__init__(config)
        ndev = int(n_devices) if n_devices else mesh_device_count(config.device)
        self.shards = shard_devices(config.device, ndev)  # raises when too few
        self.devices = ndev
        # capacity class: a mesh host marks ndev chunks per round
        self.capacity = ndev
        self.launches = 0  # one per shape group

    def _run_group(self, Wpad: int, periods: tuple, c_pad: int,
                   rows: list[TieredSegment]) -> np.ndarray:
        b = len(rows)
        ndev = self.devices
        per = next_pow2(-(-b // ndev))
        rows = rows + [rows[0]] * (ndev * per - b)
        tables = stack_tables(rows, periods, c_pad)
        kind = pair_kind(self.config)
        with trace.span("segment.device", backend=self.name, batch=b,
                        padded=len(rows), devices=ndev):
            outs = [
                mark_words_batch(Wpad, kind, periods,
                                 *_rows(tables, d * per, (d + 1) * per), device=dev)
                for d, dev in enumerate(self.shards)
            ]
            self.launches += 1
            return torch.cat([o.cpu() for o in outs]).numpy()[:b]
