"""Elastic worlds: survive a host loss by shrinking, not exiting, and
admit returned or replacement hosts by growing.

Counterpart of ``pytorch_distributed_mnist_tpu/runtime/elastic.py``, on
the port's launcher (``parallel/launcher.py``). The supervision layer
(``runtime/supervision.py``) turns a dead process into a clean agreed
exit: every survivor unwinds with ``PeerFailure(host, phase, reason)``
instead of waiting in a collective. This module is the layer above that
exit: on a host loss the job continues. Survivors agree the shrunk
membership, the world is rebuilt at the smaller size, the state is loaded
from the last published checkpoint (whole leaves: any world loads any
world's checkpoint, ``train/checkpoint.py``), and training resumes, with
no operator action.

Why re-exec instead of rebuilding in place: a process group's membership
is fixed at ``init_process_group``, the dead process may hold the
rendezvous, and survivors' transports are bound to the dead peer. So an
elastic supervisor process owns the workers, and each failed generation
is replaced by a smaller one started with ``--resume auto``
(``supervise``: the local twin of a cluster manager's restart policy,
behind ``--spawn N --elastic`` and ``runtime/chaos.py --elastic``).

Per generation ``g`` with members ``[h0..h{W-1}]`` (stable host ids; the
rank in the generation is the index):

1. **Detect**: a failure takes the supervised exits (poison pill,
   watchdog, transport error), ending every surviving rank in
   ``PeerFailure`` with the dead attributed, or in a transport-shaped
   error from a collective of the default group.
2. **Agree membership**: each survivor, while unwinding, writes a
   **survivor record** (``write_survivor_record``, from ``cli.run``'s
   supervised scope) into the rendezvous directory: its rank, its host id
   and the dead set its failure named. A rank that exits without a record
   is, by that fact, not a survivor.
3. **Rebuild**: the supervisor collects exits and records under a
   deadline (a second failure during the shrink only makes the next world
   smaller; a straggler is killed at the settle deadline), plans the next
   world (``plan_next_world``, pure), enforces ``--min-world`` and
   re-execs the survivors as ranks ``0..W'-1`` of generation ``g+1`` on a
   fresh rendezvous port.
4. **Resume**: generation ``g+1`` runs with ``--resume auto``, and
   records a ``world_shrunk`` event (old and new membership) into the run
   summary and the ``--metrics-file`` JSONL.

What shrinking cannot promise: the global ``--batch-size`` must still
divide over the shrunk world, and a second failure can shrink the world
below ``--min-world``, which exits ``EXIT_FLOOR`` rather than training on
a world the operator ruled out. A failure with no survivors, or one that
implicates nobody (a symmetric abort), is not a shrink event. On the card
every generation needs one card per rank, as ``--spawn`` does.

**Growing**: a returned or replacement host writes a **join record**
(``announce_join``) into the rendezvous directory. Joiners are admitted
at generation boundaries: after any failure rebuild, and, under
``--elastic-grow``, at an epoch-boundary grow rendezvous, where rank 0
lists pending join records after the epoch's checkpoint, the observation
is agreed over the supervision records, and every rank writes a YIELD
record and exits ``EXIT_GROW``. The supervisor appends the joiners
(capped by ``--max-world``) and resumes the larger world from the last
published checkpoint, recording ``world_grown``. A joiner can never
enter a running world: membership is fixed at the rendezvous.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from pytorch_distributed_mnist_tpu_torch.parallel.launcher import (
    PACKAGE,
    _child_env,
    child_device,
    free_port,
    strip_flags,
    strip_spawn_flag,
)
from pytorch_distributed_mnist_tpu_torch.runtime import supervision

# Environment contract between the supervisor and its worker processes.
# Workers never need a flag: presence of the rendezvous DIR enables the
# survivor-record path, and MEMBERS/GEN/PREV carry the membership the
# worker reports in records and the world_shrunk event.
DIR_ENV = "TPUMNIST_ELASTIC_DIR"
GEN_ENV = "TPUMNIST_ELASTIC_GEN"
MEMBERS_ENV = "TPUMNIST_ELASTIC_MEMBERS"
PREV_ENV = "TPUMNIST_ELASTIC_PREV"
# Set ("1") by a supervisor running with --elastic-grow: workers then
# run the epoch-boundary grow rendezvous (maybe_grow_rendezvous).
GROW_ENV = "TPUMNIST_ELASTIC_GROW"
# The supervisor's --max-world cap, mirrored to workers so a world
# already AT the cap skips the rendezvous entirely: without this, a
# join record the supervisor can only defer would re-trigger a yield
# (full teardown + re-exec) at EVERY epoch boundary.
MAX_WORLD_ENV = "TPUMNIST_ELASTIC_MAX_WORLD"

# Supervisor exit code when survivors would form a world below
# --min-world: distinct from worker failure codes (1, watchdog 75,
# signal 128+N) so an operator-side restart policy can tell "the job
# shrank past the floor you set" from "the job failed".
EXIT_FLOOR = 78


def generation() -> int:
    """This worker's elastic generation: 0 for the first launch (and for
    every non-elastic run), >= 1 inside a rebuilt world. Callers use it
    to tell "the operator asked for this topology" from "the supervisor
    rebuilt us into it"."""
    return int(os.environ.get(GEN_ENV, "0") or 0)

# Worker exit code for the planned grow rendezvous: every rank of a
# generation that agreed pending joiners exist yields with this code
# (plus a YIELD record — either alone proves the rank is healthy), so
# the supervisor can tell "the world paused to grow" from every failure
# shape. Distinct from 0 (trained to completion), 75 (watchdog hard
# exit), and 78 (the supervisor's floor).
EXIT_GROW = 76

# Substrings that mark an exception as transport-shaped: the peer died
# while this host was inside a DEVICE program (a step's psum) or another
# non-agreement collective, so the failure never passed through
# allgather_records' transport classifier and arrives as a raw runtime
# error. Matched case-insensitively against repr(exc). Best-effort by
# design: a miss means this rank writes no record and is treated as
# dead — strictly a smaller next world, never a hang.
_TRANSPORT_MARKERS = (
    "gloo",
    "connection closed",
    "connection reset",
    "connection refused",
    "broken pipe",
    "peer closed",
    "socket closed",
    "transport",
    "deadline exceeded",
    "heartbeat",
    "coordination service",
)


def is_transport_suspect(error: BaseException) -> bool:
    """True when ``error`` reads like the transport-level shadow of a
    peer death (see ``_TRANSPORT_MARKERS``). Used only to widen the
    survivor-record gate beyond ``PeerFailure``; never to suppress a
    real failure."""
    text = repr(error).lower()
    return any(marker in text for marker in _TRANSPORT_MARKERS)


def _members_from_env() -> List[int]:
    raw = os.environ.get(MEMBERS_ENV, "")
    return [int(tok) for tok in raw.split(",") if tok.strip() != ""]


def record_path(directory: str, generation: int, rank: int) -> str:
    return os.path.join(directory,
                        f"survivor_g{generation:03d}_r{rank:05d}.json")


def join_path(directory: str, host: int) -> str:
    return os.path.join(directory, f"join_h{host:05d}.json")


def announce_join(directory: str, host: int) -> str:
    """The joiner's announcement: a returned or replacement host writes
    one join record into the rendezvous directory and waits to be
    admitted at the next generation boundary (a failure rebuild, or an
    epoch-boundary grow rendezvous under ``--elastic-grow``). ``host``
    is the stable host id the new member will carry; a RETURNED host
    reuses its old id, a replacement picks an unused one. Atomic
    tmp+replace like the survivor votes, so the supervisor never reads
    a torn announcement. Returns the record path.

    This is the whole joiner-side protocol on purpose: admission, rank
    assignment, and resume all belong to the supervisor and the rebuilt
    generation — a joiner cannot enter a *running* world (a process
    group's membership is fixed at ``init_process_group``).
    """
    record = {"host": int(host), "wall": round(time.time(), 3)}
    path = join_path(directory, int(host))
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(record, f)
    os.replace(tmp, path)
    return path


def pending_joins(directory: str) -> List[Tuple[int, str]]:
    """All parseable join records in the rendezvous dir, sorted by host
    id: ``[(host, path), ...]``. Malformed records are warned about and
    skipped (never admitted, never deleted — the evidence stays for the
    operator); missing/unreadable dirs read as no joiners."""
    out: List[Tuple[int, str]] = []
    try:
        names = sorted(os.listdir(directory))
    except OSError:
        return out
    for name in names:
        if not (name.startswith("join_h") and name.endswith(".json")):
            continue
        path = os.path.join(directory, name)
        try:
            with open(path) as f:
                host = int(json.load(f)["host"])
        except (OSError, ValueError, KeyError, TypeError,
                json.JSONDecodeError) as exc:
            print(f"WARNING: ignoring malformed join record {path!r} "
                  f"({exc!r})", file=sys.stderr, flush=True)
            continue
        out.append((host, path))
    return sorted(out)


def plan_grow(
    members: Sequence[int],
    join_hosts: Sequence[int],
    max_world: int = 0,
) -> Tuple[List[int], List[int], List[int]]:
    """The grow half of the membership decision, as a pure function:
    ``(new_members, admitted, stale)``.

    Joiners are appended to the surviving members in host-id order
    (survivor ranks stay a prefix: the grown world's rank 0 is the old
    world's rank 0, which keeps log-follows-rank-0 stable across
    regrows). ``stale`` joiners — already members — are ignored (and the
    caller consumes their records so a host's pre-loss announcement can
    never readmit it after a later death). ``max_world`` (0 = unbounded)
    caps the TOTAL world size; joiners beyond the cap are neither
    admitted nor stale — they stay pending for a later boundary.
    """
    members = list(members)
    admitted: List[int] = []
    stale: List[int] = []
    for host in sorted(set(int(h) for h in join_hosts)):
        if host in members:
            stale.append(host)
            continue
        if max_world and len(members) + len(admitted) >= max_world:
            continue  # deferred: stays pending for a later boundary
        admitted.append(host)
    return members + admitted, admitted, stale


def write_survivor_record(error: BaseException) -> Optional[str]:
    """Worker-side membership vote: serialize this host's survival (and
    the dead set its failure named) for the supervisor; returns the
    record path, or None when this process is not an elastic worker or
    ``error`` does not qualify.

    Called from ``cli.run``'s supervised unwind, before the poison-pill
    delivery and exit escalation (the record is local sub-second file
    I/O; a pill attempt against dead transport can block for its whole
    bounded timeout, and the vote must not wait behind it). Qualifying
    errors: ``PeerFailure`` (the
    supervision channel attributed the dead hosts — ``dead_ranks`` is
    that attribution, verbatim) and transport-shaped runtime errors
    (a peer died under a device collective; dead set unknown, the
    supervisor infers it from who else exited recordless). Anything
    else — a genuine host-local error, an agreed symmetric exit,
    KeyboardInterrupt — means this host is failing, not surviving, and
    must not vote itself back into the next world.

    Best-effort on purpose: a record-write failure is reported and
    swallowed (this code runs on an unwind path and must never mask the
    run's own exception); the supervisor then counts this rank dead,
    which only shrinks the next world further.
    """
    directory = os.environ.get(DIR_ENV, "")
    if not directory:
        return None
    if isinstance(error, KeyboardInterrupt):
        return None
    peer = isinstance(error, supervision.PeerFailure)
    if not peer and not is_transport_suspect(error):
        return None
    # Capture the FAILURE's phase before entering the membership phase:
    # a transport-shaped error has no .phase of its own, and reading
    # current_phase() after set_phase below would stamp every such
    # record (and the supervisor's "lost in phase(s)" line) with
    # 'membership' instead of where the world actually died.
    failure_phase = getattr(error, "phase", None) \
        or supervision.current_phase()
    supervision.set_phase("membership")
    # The mid-rebuild fault point: a kill here is a survivor dying
    # DURING the shrink (no record lands -> the supervisor counts it
    # dead); a stall is a survivor hanging mid-shrink (killed at the
    # supervisor's settle deadline). Either way the rebuild completes.
    supervision.maybe_fault("elastic_rebuild")
    members = _members_from_env()
    gen = generation()
    rank = supervision.process_index()
    dead_ranks = sorted(getattr(error, "hosts", []) or []) if peer else []
    record = {
        "generation": gen,
        "rank": rank,
        "host": members[rank] if rank < len(members) else rank,
        "dead_ranks": dead_ranks,
        "dead_hosts": [members[r] for r in dead_ranks
                       if r < len(members)] if members else dead_ranks,
        "phase": failure_phase,
        "reason": repr(error)[:500],
        "wall": round(time.time(), 3),
    }
    path = record_path(directory, gen, rank)
    try:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(record, f)
        os.replace(tmp, path)  # atomic: the supervisor never reads a torn vote
    except Exception as exc:  # noqa: BLE001 - unwind path: never mask `error`
        print(f"WARNING: elastic survivor record {path} could not be "
              f"written ({exc!r}); the supervisor will count this rank "
              f"dead and shrink without it", file=sys.stderr, flush=True)
        return None
    print(f"process {rank}: survivor record written ({path}); dead "
          f"rank(s) {dead_ranks or 'unknown'} — awaiting rebuild into "
          f"the shrunk world", file=sys.stderr, flush=True)
    return path


def write_yield_record(join_hosts: Sequence[int]) -> Optional[str]:
    """Worker-side grow vote: serialize this rank's healthy yield at a
    grow rendezvous (the grow twin of ``write_survivor_record``, written
    on the agreed EXIT_GROW path rather than an unwind). A yield record
    is proof of a live, healthy rank — ``plan_next_world`` counts it a
    survivor — with ``yield: true`` telling the supervisor the
    generation paused to grow rather than failed. Best-effort like the
    survivor vote: on a write failure the rank still exits EXIT_GROW,
    which the supervisor maps to survivor on its own."""
    directory = os.environ.get(DIR_ENV, "")
    if not directory:
        return None
    members = _members_from_env()
    gen = generation()
    rank = supervision.process_index()
    record = {
        "generation": gen,
        "rank": rank,
        "host": members[rank] if rank < len(members) else rank,
        "yield": True,
        "join_hosts": sorted(int(h) for h in join_hosts),
        "dead_ranks": [],
        "dead_hosts": [],
        "phase": "grow_check",
        "reason": f"grow rendezvous: pending joiner(s) "
                  f"{sorted(int(h) for h in join_hosts)}",
        "wall": round(time.time(), 3),
    }
    path = record_path(directory, gen, rank)
    try:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(record, f)
        os.replace(tmp, path)
    except Exception as exc:  # noqa: BLE001 - EXIT_GROW still proves the yield
        print(f"WARNING: elastic yield record {path} could not be "
              f"written ({exc!r}); the EXIT_GROW code alone carries the "
              f"vote", file=sys.stderr, flush=True)
        return None
    return path


def maybe_grow_rendezvous() -> Optional[List[int]]:
    """Worker-side, at each epoch boundary (after the checkpoint save):
    agree whether join records are pending. Returns the agreed joiner
    host list when the generation should yield for a grow, ``None``
    otherwise (not an elastic-grow worker, world at ``--max-world``, or
    nothing pending). The caller (``cli``'s epoch loop) breaks out of
    training CLEANLY on a non-None return and only then calls
    :func:`yield_for_grow` — ordering that matters under
    ``--async-checkpoint``, where the deferred publish barrier runs on
    the saver's *clean* exit: raising from inside the saver scope would
    DROP the just-saved epoch's unpublished checkpoint and make the
    grown world resume one epoch back.

    Symmetry is the whole design: rank 0 alone lists the rendezvous dir
    (host-local file I/O — per-rank listings could disagree on a shared
    filesystem's attribute cache), but EVERY rank runs the one agreement
    collective, and every rank acts on rank 0's detail — so all ranks
    yield or none do, and the collective count stays aligned.
    """
    directory = os.environ.get(DIR_ENV, "")
    if not directory or os.environ.get(GROW_ENV, "") != "1":
        return None
    members = _members_from_env()
    max_world = int(os.environ.get(MAX_WORLD_ENV, "0") or 0)
    if max_world and len(members) >= max_world:
        # At the cap, nothing can be admitted: yielding would tear the
        # world down for a rendezvous the supervisor could only defer —
        # and the still-pending record would re-trigger it EVERY epoch.
        # (Below the cap a yield always admits at least one joiner:
        # stale member records are filtered right here.)
        return None
    joins: List[int] = []
    if supervision.process_index() == 0:
        joins = [h for h, _ in pending_joins(directory)
                 if h not in set(members)]
    supervision.set_phase("grow_check")
    records = supervision.allgather_records(
        "grow_check", True, ",".join(str(h) for h in joins))
    supervision.raise_if_poisoned(records, "the grow rendezvous")
    detail = records[0].detail
    if not detail:
        return None
    return [int(tok) for tok in detail.split(",") if tok.strip()]


def yield_for_grow(join_hosts: Sequence[int]) -> None:
    """Worker-side, after the epoch loop unwound cleanly (checkpoints —
    including an async saver's deferred publish — all on disk): write
    this rank's YIELD record and exit ``EXIT_GROW``. Always raises.

    The raise is an agreed symmetric exit (marked, never poisoned):
    every rank of the generation reached the same ``grow_check``
    agreement and leaves through here — to the supervisor, EXIT_GROW
    plus yield records is a planned regroup."""
    join_hosts = list(join_hosts)
    write_yield_record(join_hosts)
    print(f"process {supervision.process_index()}: joiner(s) "
          f"{join_hosts} pending — yielding for the grow rendezvous "
          f"(exit {EXIT_GROW}); the supervisor rebuilds the world "
          f"larger and resumes from the last published checkpoint",
          file=sys.stderr, flush=True)
    exc = SystemExit(EXIT_GROW)
    supervision.mark_agreed(exc)  # symmetric: every rank leaves raising this
    raise exc


def note_rebuilt_world() -> None:
    """Worker-side, at run start: record the ``world_shrunk`` /
    ``world_grown`` failure event when this process is the first
    generation after a membership change.

    Called from ``cli.run`` after the failure-event log is reset
    and its metrics sink attached, so the old/new membership lands in
    BOTH the run summary's ``failure_events`` block and the
    ``--metrics-file`` JSONL — the one place an operator (or the
    acceptance twins) reads what the world survived. Direction is sized:
    more members than the previous generation is a grow, fewer a
    shrink; a same-size membership CHANGE (a loss whose replacement
    rode the same rebuild) records as ``world_grown`` — a new host
    joined, and the old/new member lists carry the loss. No-op outside
    a rebuilt elastic generation, and for an unchanged relaunch.
    """
    prev = os.environ.get(PREV_ENV, "")
    if not prev or not os.environ.get(DIR_ENV, ""):
        return
    from pytorch_distributed_mnist_tpu_torch.utils.profiling import (
        record_world_grown,
        record_world_shrunk,
    )

    supervision.set_phase("rebuild")
    old_members = [int(t) for t in prev.split(",") if t.strip() != ""]
    new_members = _members_from_env()
    if new_members == old_members:
        return  # a same-membership relaunch changed no topology
    gen = generation()
    if len(new_members) < len(old_members):
        record_world_shrunk(old_members, new_members, gen)
    else:
        record_world_grown(old_members, new_members, gen)


# ---------------------------------------------------------------------------
# Supervisor side
# ---------------------------------------------------------------------------


#: Flags consumed by the supervisor itself; stripped from worker argv
#: (a worker seeing --elastic without --spawn would reject it).
_SUPERVISOR_FLAGS = {"--elastic": 0, "--min-world": 1,
                     "--elastic-grow": 0, "--max-world": 1}


def strip_elastic_flags(argv: Sequence[str]) -> List[str]:
    """Remove supervisor-only flags (``--elastic``, ``--min-world N``,
    ``--elastic-grow``, ``--max-world N``, ``=``-joined forms included)
    from an argv copy."""
    return strip_flags(argv, _SUPERVISOR_FLAGS)


def _strip_resume(argv: Sequence[str]) -> List[str]:
    """Remove any user ``--resume X`` (rebuilt generations always
    resolve the last published checkpoint themselves via ``auto``)."""
    return strip_flags(argv, {"--resume": 1})


def plan_next_world(
    nranks: int,
    returncodes: Sequence[Optional[int]],
    record_ranks: Sequence[int],
) -> Tuple[List[int], List[int]]:
    """The membership decision, as a pure function: ``(survivor_ranks,
    dead_ranks)`` for one failed generation.

    A rank survives iff it *proved* it: exit code 0 (it finished — only
    possible when the failure struck after its last collective), or a
    survivor record on disk (it unwound through the supervised exit and
    voted). Everything else — signal-killed, exited on its own error
    without a record, killed as a straggler at the settle deadline — is
    dead. Record presence outranks the exit code on purpose: a survivor
    whose interpreter teardown hung in the dead world's shutdown
    barrier (killed by the supervisor or hard-exited at code 75) is
    still a healthy host; the record landing is the proof it unwound.
    """
    records = set(record_ranks)
    survivors = [r for r in range(nranks)
                 if r in records or returncodes[r] == 0]
    dead = [r for r in range(nranks) if r not in survivors]
    return survivors, dead


@dataclass
class GenerationResult:
    """One generation's outcome, as the supervisor saw it."""

    generation: int
    members: List[int]
    returncodes: List[Optional[int]]
    records: Dict[int, dict] = field(default_factory=dict)
    stragglers: List[int] = field(default_factory=list)
    log_tails: Dict[int, str] = field(default_factory=dict)

    @property
    def clean(self) -> bool:
        return all(rc == 0 for rc in self.returncodes)

    def first_bad_rc(self) -> int:
        for rc in self.returncodes:
            if rc not in (0, None):
                return rc if rc > 0 else 128 - rc
        return 1


def _say(msg: str) -> None:
    print(f"elastic: {msg}", file=sys.stderr, flush=True)


def _run_generation(
    generation: int,
    members: List[int],
    child_argv: List[str],
    rendezvous_dir: str,
    prev_members: Optional[List[int]],
    settle_timeout: float,
    generation_timeout: float,
    grow: bool = False,
    max_world: int = 0,
    device: str = "cuda",
) -> GenerationResult:
    """Spawn one generation's worker processes and wait them all out.

    Rank 0 streams to this terminal (the operator watches one log, like
    ``--spawn``); other ranks capture to temp files, tails kept for the
    postmortem of ranks that die. Exit collection is deadline-bounded
    twice over: the whole generation by ``generation_timeout``, and —
    once any rank has exited abnormally — the remaining ranks by
    ``settle_timeout`` from that moment. Ranks still alive past either
    deadline are killed and counted stragglers: a shrink can therefore
    stall for at most ``settle_timeout``, never hang (the
    second-failure-during-rebuild guarantee the mid-rebuild chaos
    scenarios pin).
    """
    nranks = len(members)
    env = _child_env()
    env[DIR_ENV] = rendezvous_dir
    env[GEN_ENV] = str(generation)
    env[MEMBERS_ENV] = ",".join(str(m) for m in members)
    if prev_members is not None:
        env[PREV_ENV] = ",".join(str(m) for m in prev_members)
    else:
        env.pop(PREV_ENV, None)
    if grow:
        env[GROW_ENV] = "1"
    else:
        env.pop(GROW_ENV, None)
    if max_world:
        env[MAX_WORLD_ENV] = str(max_world)
    else:
        env.pop(MAX_WORLD_ENV, None)

    rendezvous: List[str] = []
    if nranks > 1:
        rendezvous = ["--coordinator", f"127.0.0.1:{free_port()}"]
    procs, logs = [], []
    for rank in range(nranks):
        cmd = [sys.executable, "-m", PACKAGE, *child_argv,
               "--device", child_device(device, rank)]
        if nranks > 1:
            cmd += [*rendezvous, "--num-processes", str(nranks),
                    "--process-id", str(rank)]
        if rank == 0:
            procs.append(subprocess.Popen(cmd, env=env))
            logs.append(None)
        else:
            # Temp files, not pipes: a filled pipe buffer would deadlock
            # a chatty child against a parent that reads at the end.
            log = tempfile.TemporaryFile(mode="w+")
            procs.append(subprocess.Popen(
                cmd, env=env, stdout=log, stderr=subprocess.STDOUT))
            logs.append(log)

    started = time.monotonic()
    first_bad_exit: Optional[float] = None
    stragglers: List[int] = []
    try:
        while True:
            rcs = [p.poll() for p in procs]
            if all(rc is not None for rc in rcs):
                break
            now = time.monotonic()
            if first_bad_exit is None and any(
                    rc is not None and rc != 0 for rc in rcs):
                first_bad_exit = now
            over_settle = (first_bad_exit is not None
                           and now - first_bad_exit > settle_timeout)
            over_total = now - started > generation_timeout
            if over_settle or over_total:
                why = ("settle deadline" if over_settle
                       else "generation timeout")
                for rank, p in enumerate(procs):
                    if p.poll() is None:
                        limit = (settle_timeout if over_settle
                                 else generation_timeout)
                        _say(f"generation {generation}: rank {rank} (host "
                             f"{members[rank]}) still running past the "
                             f"{why} ({limit:g}s); killing it")
                        stragglers.append(rank)
                break
            time.sleep(0.2)
    finally:
        # Every exit path — normal drain, deadline kill, or an exception
        # mid-wait (KeyboardInterrupt included) — reaps every child: an
        # unreaped rank would keep its card allocated long past the
        # generation.
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()

    result = GenerationResult(
        generation=generation, members=list(members),
        returncodes=[p.returncode for p in procs], stragglers=stragglers,
    )
    for rank in range(nranks):
        path = record_path(rendezvous_dir, generation, rank)
        if os.path.isfile(path):
            try:
                with open(path) as f:
                    result.records[rank] = json.load(f)
            except (OSError, json.JSONDecodeError) as exc:
                _say(f"generation {generation}: unreadable survivor "
                     f"record for rank {rank} ({exc!r}); counting it dead")
    for rank, log in enumerate(logs):
        if log is None:
            continue
        try:
            log.seek(0)
            result.log_tails[rank] = log.read()[-4000:]
        finally:
            log.close()
    return result


def supervise(
    nprocs: int,
    argv: Sequence[str],
    *,
    min_world: int = 1,
    max_world: int = 0,
    grow: bool = False,
    rejoin: Sequence[Tuple[int, int]] = (),
    settle_timeout: float = 60.0,
    generation_timeout: float = 600.0,
    rendezvous_dir: Optional[str] = None,
    device: str = "cuda",
) -> int:
    """Run an elastic local world: spawn ``nprocs`` ranks, and on a host
    loss rebuild the survivors into a smaller world resumed from the
    last published checkpoint — and, when join records land in the
    rendezvous dir, rebuild the world LARGER the same way — until the
    job completes or cannot continue. Returns a process exit code (0 =
    the job trained to completion on whatever world remained).

    ``grow`` (``--elastic-grow``) additionally makes every generation
    run the epoch-boundary grow rendezvous, so joiners are admitted
    between epochs instead of only riding failure rebuilds. ``max_world``
    (``--max-world``, 0 = unbounded) caps the grown size. ``rejoin`` is
    the local join hook behind ``runtime/chaos.py --rejoin``: for each
    ``(host, generation)`` pair the supervisor writes that host's join
    record (:func:`announce_join`) just before it spawns that
    generation, a deterministic stand-in for a replacement host that
    announces itself while generation ``g`` runs.

    ``device`` is the workers' ``--device`` (``cuda`` unless named, as
    the CLI's default): rank r of a generation on the card takes
    ``cuda:r``, and a generation with more ranks than visible cards is
    refused (exit 2), as ``--spawn`` refuses it.

    The local twin of a cluster manager's restart policy, driven by
    ``--spawn N --elastic [--min-world M] [--elastic-grow]`` and
    ``runtime/chaos.py --elastic``. Non-shrink failures propagate: a
    generation that fails with no survivor records and no one killed
    (a symmetric agreed abort, a bad flag) exits with that failure's
    code rather than thrashing through rebuild attempts.
    """
    if nprocs < 2:
        raise ValueError(
            f"elastic supervision needs an initial world of >= 2 "
            f"processes, got {nprocs}")
    if min_world < 1:
        raise ValueError(f"--min-world must be >= 1, got {min_world}")
    if min_world > nprocs:
        raise ValueError(
            f"--min-world {min_world} exceeds the initial world size "
            f"{nprocs}")
    if max_world < 0 or (max_world and max_world < nprocs):
        raise ValueError(
            f"--max-world {max_world} is below the initial world size "
            f"{nprocs} (0 = unbounded)")
    base_argv = strip_flags(strip_spawn_flag(strip_elastic_flags(argv)),
                            {"--device": 1})
    own_dir = rendezvous_dir is None
    if own_dir:
        rendezvous_dir = tempfile.mkdtemp(prefix="tpumnist-elastic-")
    members = list(range(nprocs))
    prev: Optional[List[int]] = None
    generation = 0
    rc: Optional[int] = None

    def _admit_joiners(new_members: List[int]) -> List[int]:
        """Read, plan, and consume pending join records against the
        next world's membership; returns the (possibly grown) member
        list. Stale records (hosts already members) are consumed too —
        a host's pre-loss announcement must never readmit it after a
        later death; deferred-by---max-world records stay pending."""
        pending = pending_joins(rendezvous_dir)
        if not pending:
            return new_members
        paths = dict(pending)
        grown, admitted, stale = plan_grow(
            new_members, [h for h, _ in pending], max_world)
        for host in admitted + stale:
            try:
                os.remove(paths[host])
            except OSError:
                pass  # consumed logically either way
        if stale:
            _say(f"ignoring stale join record(s) for host(s) {stale} "
                 f"(already members)")
        deferred = sorted(set(h for h, _ in pending)
                          - set(admitted) - set(stale))
        if deferred:
            _say(f"join record(s) for host(s) {deferred} deferred: "
                 f"--max-world {max_world} caps the world; they stay "
                 f"pending for a later boundary")
        if admitted:
            _say(f"admitting joiner host(s) {admitted} into the next "
                 f"generation")
        return grown

    def _loop() -> int:
        nonlocal members, prev, generation
        while True:
            child_argv = list(base_argv)
            if generation > 0:
                child_argv = _strip_resume(child_argv) + ["--resume", "auto"]
            for host, at_generation in rejoin:
                # The join hook: this host's record lands while
                # generation `at_generation` runs (written just before
                # the spawn, as a returning host would through
                # announce_join).
                if at_generation == generation:
                    announce_join(rendezvous_dir, host)
                    _say(f"host {host} announced a join (rejoin hook); "
                         f"admitted at the next generation boundary")
            _say(f"generation {generation}: world size {len(members)} "
                 f"(hosts {members})"
                 + (", resuming from the last published checkpoint"
                    if generation else ""))
            if device.startswith("cuda"):
                import torch

                cards = torch.cuda.device_count()
                if len(members) > cards:
                    _say(f"generation {generation}: {len(members)} ranks "
                         f"on {device}, but NCCL needs one card per rank "
                         f"and {cards} card(s) are visible")
                    return 2
            result = _run_generation(
                generation, members, child_argv, rendezvous_dir, prev,
                settle_timeout, generation_timeout, grow=grow,
                max_world=max_world, device=device)
            if result.clean:
                _say(f"generation {generation}: trained to completion "
                     f"on world size {len(members)}")
                return 0
            # EXIT_GROW is a healthy planned yield, not a failure: map
            # it to a clean exit for the membership plan (a yield record
            # normally proves it too, but the exit code alone suffices
            # when the record write failed).
            yielded = (
                any(rc == EXIT_GROW for rc in result.returncodes)
                or any(rec.get("yield") for rec in result.records.values())
            )
            survivors, dead = plan_next_world(
                len(members),
                [0 if rc == EXIT_GROW else rc
                 for rc in result.returncodes],
                list(result.records))
            dead_hosts = [members[r] for r in dead]
            for rank in dead:
                tail = result.log_tails.get(rank)
                if tail:
                    print(f"--- generation {generation} rank {rank} "
                          f"(host {members[rank]}) died "
                          f"(rc={result.returncodes[rank]}) ---\n{tail}",
                          file=sys.stderr, flush=True)
            if not dead and not yielded:
                # Everyone claims survival yet the generation failed:
                # a symmetric abort (divergence SystemExit, vote
                # rejection). There is nothing to shrink around.
                _say(f"generation {generation}: failed with no dead "
                     f"host (symmetric abort); not a shrink event")
                return result.first_bad_rc()
            if not survivors:
                _say(f"generation {generation}: no survivors (every "
                     f"rank died or left no record); the world is gone")
                return result.first_bad_rc()
            new_members = [members[r] for r in survivors]
            disagreements = {
                rank: rec["dead_hosts"] for rank, rec in
                sorted(result.records.items())
                if rec.get("dead_hosts") and
                set(rec["dead_hosts"]) - set(dead_hosts)
            }
            if disagreements:
                # Expected for watchdog/timeout attributions (a host
                # blocked in an agreement cannot see WHICH peer is
                # missing, so it implicates every other host); a pill
                # names the one true failer. Either way a record is
                # proof of a live unwind, so an implicated host that
                # demonstrably voted survives — surfaced, not obeyed.
                _say(f"generation {generation}: record dead-sets "
                     f"disagree with observed exits ({disagreements} vs "
                     f"{dead_hosts}); trusting observed exits")
            # Joiners ride EVERY generation boundary: the planned grow
            # rendezvous, and any failure rebuild a replacement arrived
            # during (admitted before the floor check on purpose — a
            # loss whose replacement already announced keeps the world
            # at or above the floor).
            new_members = _admit_joiners(new_members)
            if len(new_members) < min_world:
                _say(f"generation {generation}: host(s) {dead_hosts} "
                     f"lost; {len(new_members)} survivor(s) "
                     f"{new_members} is below --min-world {min_world} "
                     f"— exiting ({EXIT_FLOOR}) instead of training on "
                     f"a world the operator ruled out")
                return EXIT_FLOOR
            if yielded and not dead and new_members == members:
                # A yield with nothing to admit (the joiner's record
                # vanished between the workers' check and this plan):
                # relaunch the same world — never an error, never a
                # tight loop (the next yield needs a fresh join record;
                # the --max-world-deferred case cannot reach here, the
                # workers skip the rendezvous at the cap).
                _say(f"generation {generation}: grow rendezvous found "
                     f"nothing to admit; relaunching the same world")
            elif dead:
                phases = sorted({rec.get("phase", "?")
                                 for rec in result.records.values()})
                _say(f"generation {generation}: host(s) {dead_hosts} "
                     f"lost in phase(s) {phases or '?'}"
                     f"; survivors {[members[r] for r in survivors]} "
                     f"agree — rebuilding at world size "
                     f"{len(new_members)} (members {new_members})")
            else:
                _say(f"generation {generation}: grow rendezvous — "
                     f"rebuilding at world size {len(new_members)} "
                     f"(members {new_members}), resumed from the last "
                     f"published checkpoint")
            prev, members = members, new_members
            generation += 1

    try:
        rc = _loop()
        return rc
    finally:
        if own_dir:
            if rc == 0:
                import shutil

                shutil.rmtree(rendezvous_dir, ignore_errors=True)
            else:
                # The records ARE the membership evidence: keep them
                # for the postmortem of a run that could not continue.
                _say(f"survivor records kept for postmortem: "
                     f"{rendezvous_dir}")
