"""Composable fault injection: the reference's ``sieve/chaos.py`` grammar.

A schedule is comma-separated items ``kind:worker@s<seg>[:param]``::

    --chaos "kill:1@s4,stall:2@s7:3.0,drop_hb:any@s9,disconnect:0@s2"

The cluster plane's kinds:

* ``kill:w@sK``            the worker hard-exits (``os._exit``) on
                           receiving segment K.
* ``stall:w@sK:secs``      the worker finishes K, then stays silent for
                           ``secs`` (default 1.0) before replying.
* ``drop_hb:w@sK``         no progress heartbeats during segment K.
* ``disconnect:w@sK:secs`` the worker drops the connection ``secs``
                           (default 0.05) into segment K and reconnects.

The service's kinds (``svc_*``, ``backend_down``, ``replica_down``,
``store_torn_write``) parse here too, with the reference's defaults and
checks, so one ``--chaos`` string means the same in both packages; the
cluster ignores them. Each plane draws only its own kinds
(:meth:`ChaosSchedule.take_kinds`): the server's dispatcher the
``SERVICE_REQUEST_KINDS`` on its request sequence number, its ledger
follower ``svc_refresh_corrupt`` on refresh attempts, its batcher
``svc_batch_partial`` on batch dispatches, its cold backend
``svc_mesh_fail`` on mesh launches, the store ``store_torn_write`` on
appends, and the ``profile`` op ``svc_prof_gap`` on profile pulls. The
router's (``ROUTER_REQUEST_KINDS``) and the observer's
(``OBSERVER_KINDS``) kinds belong to planes of their own.

``worker`` is an integer id, or ``any``/``*`` for whichever worker draws
the segment. Directives travel to the worker inside the ``assign``
message and are consumed when taken, so a reassigned segment runs
fault-free and every composed scenario ends.
"""

from __future__ import annotations

import dataclasses

from sieve_torch.analysis.lockdebug import named_lock

ANY_WORKER = -1  # "any@sK": whichever worker draws segment K
KINDS = (
    "kill",
    "stall",
    "drop_hb",
    "disconnect",
    "svc_stall",
    "svc_shed",
    "backend_down",
    "svc_refresh_corrupt",
    "replica_down",
    "svc_drain",
    "svc_batch_partial",
    "svc_flood",
    "svc_shard_down",
    "svc_trace_drop",
    "svc_crash",
    "svc_slow_frame",
    "store_torn_write",
    "svc_mesh_fail",
    "svc_scrape_gap",
    "svc_prof_gap",
)
# kinds handled by the query service (sieve_torch/service/)
SERVICE_KINDS = (
    "svc_stall",
    "svc_shed",
    "backend_down",
    "svc_refresh_corrupt",
    "replica_down",
    "svc_drain",
    "svc_batch_partial",
    "svc_flood",
    "svc_trace_drop",
    "svc_crash",
    "svc_slow_frame",
    "store_torn_write",
    "svc_mesh_fail",
)
# drawn by the server's dispatcher on the request sequence number
SERVICE_REQUEST_KINDS = (
    "svc_stall",
    "svc_shed",
    "backend_down",
    "replica_down",
    "svc_drain",
    "svc_flood",
    "svc_trace_drop",
    "svc_crash",
    "svc_slow_frame",
)
# drawn by the router on ITS request sequence; the worker field names a
# shard index there, so shard servers never consume these
ROUTER_REQUEST_KINDS = ("svc_shard_down",)
# drawn by the fleet observer on its scrape counter; the worker field is
# the target's index in its target list
OBSERVER_KINDS = ("svc_scrape_gap",)
# drawn by the ``profile`` wire op of both serving tiers, each on its own
# profile-pull counter
PROFILE_KINDS = ("svc_prof_gap",)
# kinds whose param is a lane name ("hot"/"cold"), not seconds
LANE_PARAM_KINDS = ("svc_flood",)
_LANES = ("hot", "cold")
# default param (seconds, an index, or a lane name); None = takes no param
DEFAULT_PARAM: dict[str, float | str | None] = {
    "kill": None,
    "stall": 1.0,
    "drop_hb": None,
    "disconnect": 0.05,
    "svc_stall": 1.0,
    "svc_shed": None,
    "backend_down": 1.0,
    "svc_refresh_corrupt": None,
    "replica_down": 1.0,
    "svc_drain": None,
    "svc_batch_partial": 0.0,
    "svc_flood": "cold",
    "svc_shard_down": 1.0,
    "svc_trace_drop": None,
    "svc_crash": None,
    "svc_slow_frame": 1.0,
    "store_torn_write": None,
    "svc_mesh_fail": None,
    "svc_scrape_gap": None,
    "svc_prof_gap": None,
}


class ChaosCrash(RuntimeError):
    """Raised by the ``svc_crash`` directive. Re-raised past the service
    handler's catch-all nets, so the worker thread really dies and the
    flight recorder's ``threading.excepthook`` crash trigger fires."""


@dataclasses.dataclass(frozen=True)
class ChaosDirective:
    kind: str
    worker: int  # ANY_WORKER matches every worker
    seg_id: int
    param: float | str | None = None

    def matches(self, worker_id: int, seg_id: int) -> bool:
        return self.seg_id == seg_id and self.worker in (ANY_WORKER, worker_id)

    def to_wire(self) -> dict:
        """The per-assignment payload shipped to the worker."""
        return {"kind": self.kind, "param": self.param, "worker": self.worker}


def parse_chaos(spec: str) -> list[ChaosDirective]:
    """Parse a chaos schedule; raises ValueError naming the offending item,
    so a bad schedule fails when the config is built."""
    out: list[ChaosDirective] = []
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        parts = item.split(":")
        if len(parts) not in (2, 3):
            raise ValueError(
                f"chaos item {item!r}: expected kind:worker@s<seg>[:param]"
            )
        kind, target = parts[0], parts[1]
        if kind not in KINDS:
            raise ValueError(
                f"chaos item {item!r}: unknown kind {kind!r} "
                f"(one of {', '.join(KINDS)})"
            )
        if "@" not in target:
            raise ValueError(f"chaos item {item!r}: target must be worker@s<seg>")
        who, seg = target.split("@", 1)
        if who in ("any", "*"):
            worker = ANY_WORKER
        else:
            try:
                worker = int(who)
            except ValueError:
                raise ValueError(
                    f"chaos item {item!r}: worker must be an integer id, "
                    f"'any', or '*', got {who!r}"
                ) from None
            if worker < 0:
                raise ValueError(f"chaos item {item!r}: worker id must be >= 0")
        if not seg.startswith("s") or not seg[1:].isdigit():
            raise ValueError(
                f"chaos item {item!r}: segment must be written s<id>, got {seg!r}"
            )
        seg_id = int(seg[1:])
        if len(parts) == 3:
            if DEFAULT_PARAM[kind] is None:
                raise ValueError(f"chaos item {item!r}: {kind} takes no param")
            if kind in LANE_PARAM_KINDS:
                param = parts[2]
                if param not in _LANES:
                    raise ValueError(
                        f"chaos item {item!r}: param must be a lane "
                        f"({' or '.join(_LANES)}), got {param!r}"
                    )
            else:
                try:
                    param = float(parts[2])
                except ValueError:
                    raise ValueError(
                        f"chaos item {item!r}: param must be a number (seconds)"
                    ) from None
                if param < 0:
                    raise ValueError(f"chaos item {item!r}: param must be >= 0")
        else:
            param = DEFAULT_PARAM[kind]
        out.append(ChaosDirective(kind, worker, seg_id, param))
    return out


class ChaosSchedule:
    """Coordinator-side one-shot schedule: ``take(worker, seg)`` removes
    and returns every directive matching the assignment, as wire dicts."""

    def __init__(self, directives: list[ChaosDirective]):
        self._lock = named_lock("ChaosSchedule._lock")
        self._pending = list(directives)  # guard: _lock

    def __len__(self) -> int:
        with self._lock:
            return len(self._pending)

    def take(self, worker_id: int, seg_id: int) -> list[dict]:
        return self.take_kinds(worker_id, seg_id, None)

    def take_kinds(self, worker_id: int, seg_id: int,
                   kinds: tuple[str, ...] | None) -> list[dict]:
        """Like :meth:`take`, but only consume directives whose kind is in
        ``kinds`` (None = all): a plane that numbers its own "segments"
        (the store's append counter) draws only its own kinds."""
        with self._lock:
            hit = [d for d in self._pending if d.matches(worker_id, seg_id)
                   and (kinds is None or d.kind in kinds)]
            if hit:
                taken = set(map(id, hit))
                self._pending = [d for d in self._pending if id(d) not in taken]
        return [d.to_wire() for d in hit]

    def extend(self, directives: list[ChaosDirective]) -> None:
        """Inject more directives at runtime (the service's chaos op)."""
        with self._lock:
            self._pending.extend(directives)
