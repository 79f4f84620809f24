"""Run supervision: the agreed-exit protocol, the watchdogs of the host
collectives, and the fault-injection points.

Counterpart of ``pytorch_distributed_mnist_tpu/runtime/supervision.py``.
The failure model rests on one invariant: **no process may fail alone on
a path its peers continue past into a collective.** A lone local error
strands every peer in the next collective, and a host collective has no
deadline of its own.

- **Agreement records** (``allgather_records`` / ``agree``): every
  host-side exchange (the checkpoint phases' agreements, the dataset
  vote, the resume resolution and load agreement) is one fixed-width
  record per process: a ``K``/``E``/``P`` status byte, the sender's
  lifecycle phase and a detail string. Every exchange has the same shape,
  so a failing process's poison pill meets whatever agreement its peers
  reach next and still parses: the peers learn who failed, where and why,
  and raise ``PeerFailure`` naming all three. The records travel over the
  world's gloo group made at the rendezvous
  (``parallel/distributed.py::host_group``), beside the default group:
  under NCCL an exchange needs no card and never queues behind the train
  step's collectives.
- **Agreed exit** (``deliver_poison``): ``cli.run`` routes every
  process-local failure (data staging, a step, a checkpoint phase, eval)
  through one except path that takes part in the next exchange with a
  ``P`` record before unwinding, so the peers exit with ``PeerFailure``
  instead of waiting forever.
- **Watchdogs** (``utils/watchdog.py``): every exchange runs under a
  deadline (``--agreement-timeout`` / ``TPUMNIST_AGREEMENT_TIMEOUT``; 0,
  the default, turns them off). On expiry the process dumps a phase
  report (which phase it is blocked in, for how long, and each peer's
  phase at the last completed agreement) and raises ``PeerFailure``
  naming the silent peers. A process that dies on a peer's failure exits
  75 (``escalate_exit``).
- **Fault injection** (``FaultPlan`` / ``maybe_fault``): the named points
  of :data:`FAULT_POINTS` honor ``TPUMNIST_FAULT=point:host:kind[:arg]``,
  so the chaos harness (``runtime/chaos.py``) can kill, raise in or stall
  a chosen process at a chosen point.

What the protocol cannot promise: a poison pill reaches the peers when
their next cross-process host operation is an exchange of records. A
peer blocked inside a collective of the default group, above all the
gradient all-reduce inside the captured train step under NCCL, cannot be
reached by any host-side record; it stays blocked until the collective's
own transport notices the dead peer (gloo does when the peer's sockets
close) or its timeout passes. This module adds no watchdog on the card.
"""

from __future__ import annotations

import os
import signal
import sys
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from pytorch_distributed_mnist_tpu_torch.parallel.distributed import (
    process_count,
    process_index,
)
from pytorch_distributed_mnist_tpu_torch.utils.profiling import failure_events
from pytorch_distributed_mnist_tpu_torch.utils.watchdog import (
    WatchdogTimeout,
    run_with_deadline,
)

# One process's record: 1 status byte + "phase\x1fdetail", NUL-padded.
# Every supervision exchange carries exactly this shape, so exchanges met
# out of order (a poison pill meeting whatever agreement the peers reach
# next) still pair and parse. Status bytes: ``K`` ok, ``E`` this process's
# outcome of THIS agreement was a failure (a vote), ``P`` this process is
# dying on a local error and the record is its poison pill.
RECORD_BYTES = 4352
# Room for a record's detail (the status byte, the phase's cap and the
# separator take the rest).
DETAIL_BYTES = RECORD_BYTES - 160
_SEP = b"\x1f"
_OK, _ERR, _POISON = b"K", b"E", b"P"

TIMEOUT_ENV = "TPUMNIST_AGREEMENT_TIMEOUT"
FAULT_ENV = "TPUMNIST_FAULT"
# A failing process's poison exchange is bounded even with the watchdogs
# off: peers stuck in a device collective never meet it, and the failing
# process must not trade its exit for a new hang.
POISON_TIMEOUT_DEFAULT = 60.0


class PeerFailure(RuntimeError):
    """Another process failed (or went silent) and this one must unwind.

    ``hosts`` are the implicated process indices, ``phase`` the failure's
    phase (the peer's own when it sent a record; the local agreement's on
    a watchdog timeout), ``reason`` a short string. ``already_agreed``
    tells the agreed exit to send no poison pill for it: the peers know
    already, or are beyond reach."""

    already_agreed = True

    def __init__(self, message: str, *, hosts: List[int], phase: str,
                 reason: str = "") -> None:
        super().__init__(message)
        self.hosts = list(hosts)
        self.phase = phase
        self.reason = reason


class InjectedFault(RuntimeError):
    """Raised by a ``kind=raise`` fault point (the chaos harness)."""


# ---------------------------------------------------------------------------
# Fault injection
# ---------------------------------------------------------------------------

# Every injectable fault point of the port, name -> where it fires.
# ``runtime/chaos.py --list`` renders this table, and the tests pin that
# every maybe_fault() call site in the package names one of these and
# every one of these has a call site.
FAULT_POINTS: Dict[str, str] = {
    "data_stage": "cli._build_loaders entry: dataset load/staging on this "
                  "host, before the cross-host dataset agreement",
    "train_epoch": "Trainer.train entry: host-side work of one training "
                   "epoch (staging, dispatch)",
    "train_step": "Trainer.train per-batch loop (stepwise/explicit "
                  "modes): before each step's dispatch, so kills land "
                  "BETWEEN device steps mid-epoch (scan mode replays the "
                  "epoch's captured step with no per-step host "
                  "boundary to hook)",
    "eval": "Trainer.evaluate entry: host-side work of one eval pass",
    "ckpt_prepare": "checkpoint._sharded_prepare entry: tmp-dir cleanup "
                    "before the prepare agreement",
    "ckpt_collect": "checkpoint sharded-save collect phase: the copy of "
                    "the owned leaves off the device, before the write "
                    "agreement",
    "ckpt_write": "checkpoint._sharded_write_files entry: shard/index/"
                  "meta file I/O (the async writer thread's phase)",
    "ckpt_publish": "checkpoint publish agreement: _sharded_publish "
                    "entry, and the whole-file save's publish agreement "
                    "in a world of processes, immediately before the "
                    "collective",
    "resume": "cli resume section entry: before checkpoint resolution "
              "and the resume agreements",
    "download_fetch": "data.download._fetch entry: one mirror fetch "
                      "attempt",
    "elastic_rebuild": "runtime/elastic.py survivor-record write: a "
                       "surviving worker between its PeerFailure and "
                       "its shrink exit; kill/stall here is a SECOND "
                       "failure during the world rebuild (the "
                       "supervisor must shrink further, never hang)",
}

_FAULT_KINDS = ("kill", "raise", "stall")


@dataclass
class FaultPlan:
    """One injected fault: ``point:host:kind[:arg]``.

    ``host`` is a process index or ``*`` (every process). ``kind``:
    ``kill`` (SIGKILL this process: a preemption), ``raise`` (raise
    ``InjectedFault``: a process-local error), ``stall`` (sleep ``arg``
    seconds, default 3600: a silent peer). For ``kill`` and ``raise``,
    ``arg`` is the number of matching hits to skip before firing (the
    second epoch's entry is ``train_epoch:*:kill:1``)."""

    point: str
    host: str
    kind: str
    arg: float = 0.0

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        if "," in spec:
            raise ValueError(
                f"bad {FAULT_ENV} spec {spec!r}: one fault per spec "
                f"(comma-join multiple specs and parse with "
                f"parse_fault_specs)")
        parts = spec.split(":")
        if len(parts) not in (3, 4):
            raise ValueError(f"bad {FAULT_ENV} spec {spec!r}: expected "
                             f"point:host:kind[:arg]")
        point, host, kind = parts[:3]
        if point not in FAULT_POINTS:
            raise ValueError(
                f"bad {FAULT_ENV} spec {spec!r}: unknown fault point "
                f"{point!r} (python -m pytorch_distributed_mnist_tpu_torch"
                f".runtime.chaos --list enumerates them)")
        if kind not in _FAULT_KINDS:
            raise ValueError(f"bad {FAULT_ENV} spec {spec!r}: unknown kind "
                             f"{kind!r} (one of {', '.join(_FAULT_KINDS)})")
        if host != "*":
            try:
                int(host)
            except ValueError:
                raise ValueError(
                    f"bad {FAULT_ENV} spec {spec!r}: host must be a "
                    f"process index or '*'") from None
        arg = float(parts[3]) if len(parts) == 4 else (
            3600.0 if kind == "stall" else 0.0)
        return cls(point=point, host=host, kind=kind, arg=arg)

    def matches(self, point: str) -> bool:
        if point != self.point:
            return False
        return self.host == "*" or int(self.host) == process_index()

    def fire(self) -> None:
        detail = f"{self.point}:{self.host}:{self.kind}"
        print(f"chaos: process {process_index()} firing injected fault "
              f"{detail}", file=sys.stderr, flush=True)
        if self.kind == "kill":
            sys.stderr.flush()
            sys.stdout.flush()
            os.kill(os.getpid(), signal.SIGKILL)
            return  # unreachable
        if self.kind == "stall":
            time.sleep(self.arg)
            return
        raise InjectedFault(f"injected fault at {detail} (chaos harness)")


def parse_fault_specs(spec: str) -> List[FaultPlan]:
    """Parse ``point:host:kind[:arg][,point:host:kind[:arg]...]`` (the
    ``TPUMNIST_FAULT`` grammar). Several plans serve the mid-rebuild
    scenarios: the first injects the host loss, the second sabotages a
    survivor during the shrink (``elastic_rebuild``). Host indices are
    ranks in the world that reads the plan: in an elastic run, each
    generation's ranks."""
    plans = [FaultPlan.parse(part) for part in spec.split(",")
             if part.strip()]
    if not plans and spec.strip():
        raise ValueError(f"bad {FAULT_ENV} spec {spec!r}: no fault specs")
    return plans


_fault_plans: List[FaultPlan] = []
_fault_parsed = False
_fault_hits: Dict[str, int] = {}


def _load_fault_plans() -> List[FaultPlan]:
    global _fault_plans, _fault_parsed
    if not _fault_parsed:
        spec = os.environ.get(FAULT_ENV, "").strip()
        _fault_plans = parse_fault_specs(spec) if spec else []
        _fault_parsed = True
    return _fault_plans


def maybe_fault(point: str) -> None:
    """Fire the first configured fault whose point and host match. Call
    sites name a string literal of ``FAULT_POINTS`` (pinned by the tests);
    with no plan set this is one list probe. Matching hits are counted per
    point."""
    assert point in FAULT_POINTS, f"unregistered fault point {point!r}"
    plans = [p for p in _load_fault_plans() if p.matches(point)]
    if not plans:
        return
    hits = _fault_hits.get(point, 0)
    _fault_hits[point] = hits + 1
    for plan in plans:
        if plan.kind in ("kill", "raise") and hits < int(plan.arg):
            continue  # arg = matching hits to skip first
        plan.fire()
        return


# ---------------------------------------------------------------------------
# Supervisor state
# ---------------------------------------------------------------------------

_timeout: float = 0.0
_hard_exit_after: Optional[float] = None
_phase: str = "startup"
_agreements: int = 0
# host -> {"phase", "agreement", "wall"} from the last completed agreement:
# the per-host heartbeat the watchdog report prints.
_last_seen: Dict[int, Dict] = {}


def resolve_timeout(timeout: Optional[float] = None) -> float:
    """The agreement deadline: ``timeout`` (the ``--agreement-timeout``
    flag) wins over ``TPUMNIST_AGREEMENT_TIMEOUT``, else 0 (off)."""
    if timeout is None:
        env = os.environ.get(TIMEOUT_ENV, "").strip()
        try:
            timeout = float(env) if env else 0.0
        except ValueError:
            raise SystemExit(f"{TIMEOUT_ENV}={env!r} is not a number of "
                             f"seconds")
    return max(0.0, float(timeout))


def configure(timeout: Optional[float] = None,
              hard_exit_after: Optional[float] = 30.0) -> float:
    """(Re)arm the supervisor for one run; returns the effective timeout
    (:func:`resolve_timeout`). Also resets the phase, the heartbeats and
    the fault-plan cache, so a later ``cli.run`` in the same process
    supervises its own run only."""
    global _timeout, _hard_exit_after, _phase, _agreements
    global _fault_parsed, _fault_plans
    _timeout = resolve_timeout(timeout)
    _hard_exit_after = hard_exit_after
    _phase = "startup"
    _agreements = 0
    _last_seen.clear()
    _fault_parsed = False
    _fault_plans = []
    _fault_hits.clear()
    return _timeout


def set_phase(phase: str) -> str:
    """Mark the lifecycle phase this process enters (for the reports and
    the poison pill's attribution); returns the previous one."""
    global _phase
    prev, _phase = _phase, phase
    return prev


def current_phase() -> str:
    return _phase


def _dump_phase_report(label: str, started: float) -> None:
    """The watchdog's report on stderr: who this is, where it is stuck,
    and every peer's last heartbeat."""
    from pytorch_distributed_mnist_tpu_torch.parallel.distributed import (
        runtime_info,
    )

    info = runtime_info()
    topo = ", ".join(f"{k}={info[k]}" for k in sorted(info)
                     if k != "initialized_at")
    lines = [
        f"=== supervision watchdog report (process {process_index()}) ===",
        f"world: {topo}",
        f"blocked in: {label}",
        f"lifecycle phase: {_phase}",
        f"waited: {time.time() - started:.1f}s (deadline {_timeout:g}s)",
        f"completed agreements this run: {_agreements}",
    ]
    if _last_seen:
        lines.append("per-host last heartbeat (phase reported at the last "
                     "completed agreement):")
        for host in sorted(_last_seen):
            rec = _last_seen[host]
            age = time.time() - rec["wall"]
            lines.append(f"  host {host}: phase {rec['phase']!r} at "
                         f"agreement #{rec['agreement']}, {age:.1f}s ago")
    else:
        lines.append("no completed agreements yet: peers' phases unknown "
                     "(a host may have died before the first agreement)")
    lines.append("which hosts reached this collective cannot be observed "
                 "from inside it; suspects = every host but this one")
    print("\n".join(lines), file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# Agreement collectives
# ---------------------------------------------------------------------------


@dataclass
class Record:
    """One process's decoded agreement record."""

    status: str  # "K" | "E" | "P"
    phase: str   # the sender's lifecycle phase when it sent the record
    detail: str

    @property
    def ok(self) -> bool:
        return self.status == "K"

    @property
    def poisoned(self) -> bool:
        return self.status == "P"


def _encode_record(status: bytes, detail: str) -> bytes:
    body = status + _phase.encode()[:128] + _SEP \
        + detail.encode()[:DETAIL_BYTES]
    return body.ljust(RECORD_BYTES, b"\0")


def _decode_record(raw: bytes) -> Record:
    raw = raw.rstrip(b"\0")
    status = raw[:1].decode(errors="replace") or "?"
    phase, _, detail = raw[1:].partition(_SEP)
    return Record(status, phase.decode(errors="replace"),
                  detail.decode(errors="replace"))


def _raw_allgather(payload: np.ndarray) -> np.ndarray:
    """One all-gather of ``payload`` (uint8, ``RECORD_BYTES``) over the
    world's gloo group of records (the default group in a world that
    ``parallel/distributed.py`` did not make); ``(processes,
    RECORD_BYTES)``. Split out so tests can stall or patch it."""
    import torch
    import torch.distributed as dist

    from pytorch_distributed_mnist_tpu_torch.parallel.distributed import (
        host_group,
    )

    mine = torch.from_numpy(np.array(payload, dtype=np.uint8))
    out = [torch.empty_like(mine) for _ in range(process_count())]
    dist.all_gather(out, mine, group=host_group())
    return torch.stack(out).numpy()


def _collective_with_deadline(fn: Callable, label: str):
    started = time.time()
    return run_with_deadline(
        fn, timeout=_timeout, label=label,
        on_timeout=lambda: _dump_phase_report(label, started),
        hard_exit_after=_hard_exit_after)


def allgather_records(phase: str, ok: bool, detail: str = "",
                      fatal: bool = False) -> List[Record]:
    """Exchange one supervision record per process; returns the decoded
    records by process index. A single process returns its own record (no
    collective). On a watchdog expiry: the phase report, then
    ``PeerFailure`` implicating every other process; a transport failure
    (a peer died mid-exchange) raises ``PeerFailure`` too."""
    global _agreements
    status = _POISON if fatal else (_OK if ok else _ERR)
    record = _encode_record(status, detail)
    if process_count() <= 1:
        return [_decode_record(record)]
    payload = np.frombuffer(record, dtype=np.uint8)
    label = f"agreement '{phase}'"
    suspects = [h for h in range(process_count()) if h != process_index()]
    try:
        gathered = _collective_with_deadline(
            lambda: _raw_allgather(payload), label)
    except WatchdogTimeout as exc:
        failure_events.record(
            "agreement_timeout", f"{label}: peers silent past "
            f"{_timeout:g}s deadline", phase=phase, hosts=suspects)
        raise PeerFailure(
            f"PeerFailure: agreement {phase!r} timed out after "
            f"{_timeout:g}s — host(s) {suspects} never arrived (died or "
            f"stuck outside an agreed phase); see the watchdog report "
            f"above for per-host last heartbeats",
            hosts=suspects, phase=phase,
            reason="agreement deadline exceeded") from exc
    except Exception as exc:
        # The exchange failed in transport (gloo's "connection closed by
        # peer"): a peer died mid-collective. A peer failure, not a local
        # error, and already agreed: a pill sent for it would meet the
        # same dead transport.
        failure_events.record("agreement_transport_error",
                              f"{label}: {exc!r}", phase=phase,
                              hosts=suspects)
        raise PeerFailure(
            f"PeerFailure: agreement {phase!r} failed in transport — "
            f"host(s) {suspects} likely died mid-collective: {exc!r}",
            hosts=suspects, phase=phase,
            reason=f"collective transport failure: {exc!r}"[:300]) from exc
    gathered = np.asarray(gathered).reshape(process_count(), RECORD_BYTES)
    records = [_decode_record(gathered[h].tobytes())
               for h in range(process_count())]
    _agreements += 1
    now = time.time()
    for host, rec in enumerate(records):
        _last_seen[host] = {"phase": rec.phase, "agreement": _agreements,
                            "wall": now}
    return records


def agree(phase: str, error: Optional[BaseException] = None,
          detail: str = "") -> List[Tuple[int, str, str]]:
    """Agree a per-process outcome; returns ``[(host, peer_phase,
    reason), ...]`` for every failed process (``E`` votes and ``P`` pills
    alike). Every process calls it at the same logical step; callers
    re-raise ``error`` afterwards when it is set. The exchange is itself a
    barrier."""
    detail = detail or (repr(error) if error is not None else "")
    records = allgather_records(phase, error is None, detail)
    if error is not None:
        # The E record WAS this error's delivery: no second pill for it.
        mark_agreed(error)
    return [(host, rec.phase, rec.detail)
            for host, rec in enumerate(records) if not rec.ok]


def mark_agreed(error: BaseException) -> None:
    """Mark ``error`` as already known to the peers, so ``deliver_poison``
    sends no second pill for it (which no peer would pair)."""
    try:
        error._poison_delivered = True
    except AttributeError:
        pass  # exceptions with __slots__: at worst a duplicate pill


def raise_if_poisoned(records: List[Record], context: str) -> None:
    """Raise ``PeerFailure`` when a record is a peer's poison pill. Vote
    agreements (the dataset load, the resume) read a same-phase ``E`` as
    a legitimate vote; a ``P`` means the peer is dying, whatever phase
    the pill came from."""
    poisoned = [(host, rec.phase, rec.detail)
                for host, rec in enumerate(records)
                if rec.poisoned and host != process_index()]
    if poisoned:
        raise PeerFailure(
            peer_failure_message(
                poisoned,
                f"PeerFailure: host(s) {[h for h, _, _ in poisoned]} died "
                f"on a host-local error while this host was in "
                f"{context};"),
            hosts=[h for h, _, _ in poisoned], phase=poisoned[0][1],
            reason=poisoned[0][2])


def peer_failure_message(failed: List[Tuple[int, str, str]],
                         context: str) -> str:
    """Uniform rendering of failed peers' records for error messages."""
    per_host = "; ".join(f"host {h} in phase {p!r}: {r or 'no detail'}"
                         for h, p, r in failed)
    return f"{context} [{per_host}]"


def report_failure(error: BaseException) -> None:
    """Say on stderr, and record as a ``run_failed`` event, that this
    process's run is failing, in which phase and why: the one line a
    postmortem greps, whether or not there are peers to tell."""
    reason = repr(error)[:300]
    failure_events.record("run_failed", reason, phase=_phase,
                          host=process_index())
    print(f"process {process_index()}: run failed in phase {_phase!r}: "
          f"{reason}", file=sys.stderr, flush=True)


def escalate_exit(error: BaseException, grace: float = 10.0) -> None:
    """A process dying on a PEER's failure (``PeerFailure``, a watchdog
    abort: the ``already_agreed`` class) exits with the watchdog's code
    75: the error is marked ``_escalated`` (``cli.main`` exits 75 for it),
    and a hard-exit timer gives the teardown of the process group
    ``grace`` seconds, since a teardown that waits on dead peers is
    itself a hang. A symmetric failure (every process raising the same
    agreed error) is not escalated and keeps its own exit code."""
    if process_count() <= 1 or not getattr(error, "already_agreed", False):
        return
    from pytorch_distributed_mnist_tpu_torch.utils.watchdog import (
        arm_hard_exit,
    )

    try:
        error._escalated = True
    except AttributeError:
        pass
    failure_events.record("exit_escalated",
                          f"hard exit in {grace:g}s (peers unreachable)")
    arm_hard_exit(grace, "peers unreachable; the process group's teardown "
                         "may wait on them")


def deliver_poison(error: BaseException) -> None:
    """The agreed exit: take part in the next agreement with a failure
    record, so the peers unwind with ``PeerFailure`` instead of waiting at
    their next agreement.

    A no-op with one process, for an ``already_agreed`` error, for
    ``KeyboardInterrupt`` and for an error whose pill went out already
    (once per exception: a second pill would misalign every process's
    count of exchanges). The exchange is bounded (the configured timeout,
    else ``POISON_TIMEOUT_DEFAULT``) and best-effort: the original error
    is never masked."""
    if process_count() <= 1:
        return
    if getattr(error, "already_agreed", False):
        return
    if isinstance(error, KeyboardInterrupt):
        return
    if getattr(error, "_poison_delivered", False):
        return
    mark_agreed(error)
    global _timeout
    reason = repr(error)[:300]
    failure_events.record("poison_sent", reason, phase=_phase)
    print(f"process {process_index()}: host-local failure in phase "
          f"{_phase!r}; delivering poison pill to peers before exit: "
          f"{reason}", file=sys.stderr, flush=True)
    bounded = _timeout if _timeout > 0 else POISON_TIMEOUT_DEFAULT
    saved, _timeout = _timeout, bounded
    try:
        allgather_records("poison_exit", ok=False, detail=reason, fatal=True)
    except Exception as exc:
        # The peers never met the pill (dead, or stuck in a collective of
        # the default group): this process exits on its own error.
        failure_events.record(
            "poison_undelivered",
            f"no agreement within {bounded:g}s: {exc!r}", phase=_phase)
    finally:
        _timeout = saved
