"""The port's elastic runtime (``runtime/elastic.py``), its pure and
worker-side parts: the survivor and yield records, the join records,
``plan_next_world`` and ``plan_grow`` (held to the JAX functions on the
same records), the epoch-boundary grow rendezvous, the ``world_shrunk``
and ``world_grown`` events, the reshard event's direction, and the CLI's
refusals of the elastic flags. Twin of ``tests/test_elastic.py`` and of
the pure parts of ``tests/test_elastic_grow.py``; the real shrink twins
are in ``tests/test_torch_chaos.py``."""

import itertools
import json
import os

import pytest

from pytorch_distributed_mnist_tpu.runtime import elastic as jax_elastic
from pytorch_distributed_mnist_tpu_torch.runtime import elastic, supervision
from pytorch_distributed_mnist_tpu_torch.runtime.elastic import (
    DIR_ENV,
    EXIT_GROW,
    GEN_ENV,
    GROW_ENV,
    MAX_WORLD_ENV,
    MEMBERS_ENV,
    PREV_ENV,
    announce_join,
    is_transport_suspect,
    join_path,
    maybe_grow_rendezvous,
    pending_joins,
    plan_grow,
    plan_next_world,
    strip_elastic_flags,
    write_survivor_record,
    write_yield_record,
)
from pytorch_distributed_mnist_tpu_torch.utils.profiling import (
    failure_events,
)

pytestmark = pytest.mark.elastic


def _peer_failure(hosts=(1,), phase="ckpt_publish", reason="died"):
    return supervision.PeerFailure(
        "PeerFailure: test", hosts=list(hosts), phase=phase, reason=reason)


def _elastic_env(monkeypatch, tmp_path, gen=0, members="0,1"):
    monkeypatch.setenv(DIR_ENV, str(tmp_path))
    monkeypatch.setenv(GEN_ENV, str(gen))
    monkeypatch.setenv(MEMBERS_ENV, members)
    monkeypatch.delenv(PREV_ENV, raising=False)


# -- worker side: the membership vote ---------------------------------------


def test_survivor_record_written_for_peer_failure(monkeypatch, tmp_path):
    _elastic_env(monkeypatch, tmp_path, gen=2, members="0,3,5")
    path = write_survivor_record(_peer_failure(hosts=[1], phase="train@4"))
    assert path == elastic.record_path(str(tmp_path), 2, 0)
    with open(path) as f:
        rec = json.load(f)
    assert rec["generation"] == 2 and rec["rank"] == 0
    assert rec["host"] == 0  # members[rank]
    assert rec["dead_ranks"] == [1] and rec["dead_hosts"] == [3]
    assert rec["phase"] == "train@4"


def test_survivor_record_for_transport_shaped_error(monkeypatch, tmp_path):
    """A peer death surfacing inside a DEVICE program (a step's psum)
    arrives as a raw runtime error, not a PeerFailure — still a
    survivorship vote, with the dead set left for the supervisor to
    infer from who else exited recordless."""
    _elastic_env(monkeypatch, tmp_path)
    exc = ValueError(
        "UNKNOWN: Gloo AllGather failed: [external/gloo/...] "
        "Connection reset by peer [127.0.0.1]:36237")
    prev_phase = supervision.set_phase("train@1")
    try:
        path = write_survivor_record(exc)
    finally:
        supervision.set_phase(prev_phase)
    assert path is not None
    with open(path) as f:
        rec = json.load(f)
    assert rec["dead_ranks"] == [] and rec["dead_hosts"] == []
    # The record names where the world DIED, not the membership phase
    # the unwind itself enters (a transport error has no .phase of its
    # own — the pre-unwind lifecycle phase is the right attribution).
    assert rec["phase"] == "train@1"


@pytest.mark.parametrize("error", [
    RuntimeError("division by zero in my own staging code"),
    KeyboardInterrupt(),
    SystemExit("resume outcome diverged across hosts"),
])
def test_no_record_for_non_survivor_errors(monkeypatch, tmp_path, error):
    """A host failing on its OWN error (or an agreed symmetric exit, or
    the operator's ctrl-C) must not vote itself back into the world."""
    _elastic_env(monkeypatch, tmp_path)
    assert write_survivor_record(error) is None
    assert os.listdir(tmp_path) == []


def test_no_record_outside_elastic_worker(monkeypatch, tmp_path):
    monkeypatch.delenv(DIR_ENV, raising=False)
    assert write_survivor_record(_peer_failure()) is None


def test_record_write_failure_is_swallowed(monkeypatch, tmp_path, capsys):
    """The record write runs on an unwind path: an IO failure must warn
    and return None (the supervisor counts this rank dead — strictly a
    smaller world), never mask the run's own exception."""
    target = tmp_path / "not_a_dir"
    target.write_text("a file where the rendezvous dir should be")
    monkeypatch.setenv(DIR_ENV, str(target))
    monkeypatch.setenv(GEN_ENV, "0")
    monkeypatch.setenv(MEMBERS_ENV, "0,1")
    assert write_survivor_record(_peer_failure()) is None
    assert "could not be written" in capsys.readouterr().err


def test_elastic_rebuild_fault_point_fires_in_record_path(
        monkeypatch, tmp_path):
    """The mid-rebuild chaos hook: a fault injected at elastic_rebuild
    fires exactly in the survivor-record window (a second failure
    DURING the shrink)."""
    _elastic_env(monkeypatch, tmp_path)
    monkeypatch.setenv(supervision.FAULT_ENV, "elastic_rebuild:0:raise")
    monkeypatch.setattr(supervision, "_fault_parsed", False)
    try:
        with pytest.raises(supervision.InjectedFault):
            write_survivor_record(_peer_failure())
        assert os.listdir(tmp_path) == []  # died before the vote landed
    finally:
        monkeypatch.setattr(supervision, "_fault_parsed", False)
        monkeypatch.delenv(supervision.FAULT_ENV)


def test_transport_suspect_classifier():
    assert is_transport_suspect(ValueError("Gloo AllReduce failed"))
    assert is_transport_suspect(RuntimeError("connection reset by peer"))
    assert is_transport_suspect(
        RuntimeError("coordination service heartbeat failure"))
    assert not is_transport_suspect(ValueError("shapes do not match"))
    assert not is_transport_suspect(OSError("no space left on device"))


# -- worker side: the world_shrunk event ------------------------------------


def test_note_rebuilt_world_records_event(monkeypatch, tmp_path):
    _elastic_env(monkeypatch, tmp_path, gen=1, members="0,2")
    monkeypatch.setenv(PREV_ENV, "0,1,2")
    failure_events.reset()
    elastic.note_rebuilt_world()
    events = [e for e in failure_events.snapshot()
              if e["kind"] == "world_shrunk"]
    assert len(events) == 1
    assert events[0]["old_members"] == [0, 1, 2]
    assert events[0]["new_members"] == [0, 2]
    assert events[0]["generation"] == 1


def test_note_rebuilt_world_noop_outside_rebuild(monkeypatch, tmp_path):
    failure_events.reset()
    # Generation 0 (no PREV): nothing shrank yet.
    _elastic_env(monkeypatch, tmp_path)
    elastic.note_rebuilt_world()
    # Not an elastic worker at all.
    for env in (DIR_ENV, GEN_ENV, MEMBERS_ENV, PREV_ENV):
        monkeypatch.delenv(env, raising=False)
    elastic.note_rebuilt_world()
    assert [e for e in failure_events.snapshot()
            if e["kind"] == "world_shrunk"] == []


# -- supervisor side: pure membership planning ------------------------------


def test_plan_survivors_from_records_and_clean_exits():
    # rank 0 finished (rc 0), rank 1 voted (record), rank 2 SIGKILLed.
    survivors, dead = plan_next_world(3, [0, 75, -9], [1])
    assert survivors == [0, 1] and dead == [2]


def test_plan_recordless_nonzero_exit_is_dead():
    # rank 1 exited on its own error without a record: not a survivor.
    survivors, dead = plan_next_world(2, [1, 1], [0])
    assert survivors == [0] and dead == [1]


def test_plan_record_outranks_exit_code():
    # A survivor killed during teardown (hard exit 75 / supervisor
    # straggler kill -9) still survives: the record is the proof.
    survivors, dead = plan_next_world(2, [-9, -9], [0])
    assert survivors == [0] and dead == [1]


def test_plan_no_survivors():
    survivors, dead = plan_next_world(2, [-9, 1], [])
    assert survivors == [] and dead == [0, 1]


def test_plan_symmetric_failure_shrinks_nothing():
    # Everyone voted survivor (all PeerFailure'd on ... nothing dead?)
    # — plan reports no dead rank; supervise() treats that as a
    # non-shrink failure and propagates.
    survivors, dead = plan_next_world(2, [1, 1], [0, 1])
    assert survivors == [0, 1] and dead == []


# -- supervisor side: flag plumbing and validation --------------------------


def test_strip_elastic_flags():
    argv = ["--spawn", "3", "--elastic", "--min-world", "2",
            "--model", "linear", "--min-world=1", "--elastic"]
    assert strip_elastic_flags(argv) == ["--spawn", "3", "--model",
                                         "linear"]


def test_strip_resume():
    argv = ["--resume", "auto", "--model", "linear",
            "--resume=/some/path.npz"]
    assert elastic._strip_resume(argv) == ["--model", "linear"]


def test_supervise_validates_inputs():
    with pytest.raises(ValueError, match=">= 2"):
        elastic.supervise(1, [])
    with pytest.raises(ValueError, match="min-world"):
        elastic.supervise(2, [], min_world=0)
    with pytest.raises(ValueError, match="exceeds"):
        elastic.supervise(2, [], min_world=3)


def test_cli_rejects_elastic_without_spawn():
    from pytorch_distributed_mnist_tpu_torch.cli import main

    with pytest.raises(SystemExit, match="requires --spawn"):
        main(["--elastic", "--dataset", "synthetic"])


def test_cli_rejects_min_world_over_spawn():
    from pytorch_distributed_mnist_tpu_torch.cli import main

    with pytest.raises(SystemExit, match="exceeds the initial world"):
        main(["--elastic", "--spawn", "2", "--min-world", "3"])



def _grow_env(monkeypatch, tmp_path, gen=0, members="0,1", grow=True):
    monkeypatch.setenv(DIR_ENV, str(tmp_path))
    monkeypatch.setenv(GEN_ENV, str(gen))
    monkeypatch.setenv(MEMBERS_ENV, members)
    monkeypatch.delenv(PREV_ENV, raising=False)
    if grow:
        monkeypatch.setenv(GROW_ENV, "1")
    else:
        monkeypatch.delenv(GROW_ENV, raising=False)


# -- join-record IO ----------------------------------------------------------


def test_announce_and_list_joins(tmp_path):
    path = announce_join(str(tmp_path), 7)
    assert path == join_path(str(tmp_path), 7)
    announce_join(str(tmp_path), 2)
    assert pending_joins(str(tmp_path)) == [(2, join_path(str(tmp_path), 2)),
                                            (7, path)]
    # No torn reads: the write is tmp+replace, nothing else in the dir.
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]


def test_pending_joins_skips_malformed_records(tmp_path, capsys):
    announce_join(str(tmp_path), 3)
    (tmp_path / "join_h00009.json").write_text("{not json")
    (tmp_path / "join_h00011.json").write_text('{"wrong": "shape"}')
    assert [h for h, _ in pending_joins(str(tmp_path))] == [3]
    err = capsys.readouterr().err
    assert "malformed join record" in err


def test_pending_joins_missing_dir_is_empty(tmp_path):
    assert pending_joins(str(tmp_path / "nope")) == []


# -- the pure grow planner ---------------------------------------------------


def test_plan_grow_appends_joiners_after_survivors():
    new, admitted, stale = plan_grow([0, 2], [5, 1])
    # Survivor ranks stay a prefix (rank 0 keeps streaming logs);
    # joiners append in host-id order.
    assert new == [0, 2, 1, 5]
    assert admitted == [1, 5] and stale == []


def test_plan_grow_ignores_stale_member_records():
    new, admitted, stale = plan_grow([0, 1], [1, 3])
    assert new == [0, 1, 3]
    assert admitted == [3] and stale == [1]


def test_plan_grow_caps_at_max_world_and_defers_the_rest():
    new, admitted, stale = plan_grow([0], [1, 2, 3], max_world=2)
    assert new == [0, 1]
    assert admitted == [1]
    # 2 and 3 are neither admitted nor stale: they stay pending.
    assert stale == []


def test_plan_grow_unbounded_by_default_and_dedups():
    new, admitted, _ = plan_grow([0], [4, 4, 3])
    assert new == [0, 3, 4] and admitted == [3, 4]


# -- worker side: the grow rendezvous ----------------------------------------


def test_grow_rendezvous_noop_outside_elastic_grow(monkeypatch, tmp_path):
    # Not an elastic worker at all.
    for env in (DIR_ENV, GEN_ENV, MEMBERS_ENV, GROW_ENV):
        monkeypatch.delenv(env, raising=False)
    assert maybe_grow_rendezvous() is None
    # Elastic worker but no --elastic-grow: the epoch boundary is not a
    # rendezvous point (joiners still ride failure rebuilds).
    _grow_env(monkeypatch, tmp_path, grow=False)
    announce_join(str(tmp_path), 5)
    assert maybe_grow_rendezvous() is None
    # The join record is untouched for the supervisor to admit later.
    assert [h for h, _ in pending_joins(str(tmp_path))] == [5]


def test_grow_rendezvous_noop_without_pending_joiners(
        monkeypatch, tmp_path):
    _grow_env(monkeypatch, tmp_path)
    assert maybe_grow_rendezvous() is None  # no records: nothing to do
    assert os.listdir(tmp_path) == []


def test_grow_rendezvous_then_yield_writes_record_and_exit_code(
        monkeypatch, tmp_path):
    """The worker half of the grow protocol, in its two halves: the
    rendezvous AGREES the pending joiner list (returned, not raised —
    the cli epoch loop must first exit its saver scope cleanly so an
    async saver's deferred publish lands), then yield_for_grow writes
    the YIELD record (a survivor vote with yield: true) and raises the
    agreed EXIT_GROW SystemExit."""
    _grow_env(monkeypatch, tmp_path, gen=1, members="0")
    announce_join(str(tmp_path), 1)
    joiners = maybe_grow_rendezvous()
    assert joiners == [1]
    assert not os.path.exists(elastic.record_path(str(tmp_path), 1, 0))
    with pytest.raises(SystemExit) as exc_info:
        elastic.yield_for_grow(joiners)
    assert exc_info.value.code == EXIT_GROW
    # Agreed symmetric exit: marked so the unwind never poisons peers.
    assert getattr(exc_info.value, "_poison_delivered", False)
    with open(elastic.record_path(str(tmp_path), 1, 0)) as f:
        rec = json.load(f)
    assert rec["yield"] is True
    assert rec["join_hosts"] == [1]
    assert rec["dead_ranks"] == [] and rec["dead_hosts"] == []
    assert rec["phase"] == "grow_check"
    # The join record itself is NOT consumed by the worker — admission
    # (and stale filtering) is the supervisor's job.
    assert [h for h, _ in pending_joins(str(tmp_path))] == [1]


def test_grow_rendezvous_ignores_stale_member_records(
        monkeypatch, tmp_path):
    """A join record for a host that is already a member must not make
    the world yield (nothing to admit)."""
    _grow_env(monkeypatch, tmp_path, members="0,1")
    announce_join(str(tmp_path), 1)
    assert maybe_grow_rendezvous() is None  # host 1 is already a member


def test_grow_rendezvous_skipped_at_max_world_cap(monkeypatch, tmp_path):
    """A world already AT --max-world must not yield for a joiner the
    supervisor could only defer: the still-pending record would
    otherwise re-trigger a full teardown/re-exec at EVERY epoch
    boundary. The cap is mirrored to workers and the rendezvous is
    skipped outright; below the cap it runs (and a yield then always
    admits at least one joiner)."""
    _grow_env(monkeypatch, tmp_path, members="0,1")
    announce_join(str(tmp_path), 5)
    monkeypatch.setenv(MAX_WORLD_ENV, "2")
    assert maybe_grow_rendezvous() is None  # at cap: nothing admissible
    # The record stays pending (a later failure rebuild may use it as a
    # replacement).
    assert [h for h, _ in pending_joins(str(tmp_path))] == [5]
    # One slot below the cap: the rendezvous agrees the joiner.
    monkeypatch.setenv(MAX_WORLD_ENV, "3")
    assert maybe_grow_rendezvous() == [5]


def test_yield_record_write_failure_is_swallowed(monkeypatch, tmp_path,
                                                 capsys):
    target = tmp_path / "not_a_dir"
    target.write_text("a file where the rendezvous dir should be")
    monkeypatch.setenv(DIR_ENV, str(target))
    monkeypatch.setenv(GEN_ENV, "0")
    monkeypatch.setenv(MEMBERS_ENV, "0")
    assert write_yield_record([3]) is None
    assert "could not be written" in capsys.readouterr().err


# -- the world_grown event ---------------------------------------------------


def test_note_rebuilt_world_records_grow_direction(monkeypatch, tmp_path):
    _grow_env(monkeypatch, tmp_path, gen=2, members="0,1,3")
    monkeypatch.setenv(PREV_ENV, "0,1")
    failure_events.reset()
    elastic.note_rebuilt_world()
    events = failure_events.snapshot()
    grown = [e for e in events if e["kind"] == "world_grown"]
    assert len(grown) == 1
    assert grown[0]["old_members"] == [0, 1]
    assert grown[0]["new_members"] == [0, 1, 3]
    assert grown[0]["generation"] == 2
    assert [e for e in events if e["kind"] == "world_shrunk"] == []


def test_note_rebuilt_world_same_size_replacement_is_grown(
        monkeypatch, tmp_path):
    """A loss whose replacement rode the same rebuild: same world size,
    different members — a new host joined, recorded as world_grown
    (the member lists carry the loss)."""
    _grow_env(monkeypatch, tmp_path, gen=1, members="0,7")
    monkeypatch.setenv(PREV_ENV, "0,1")
    failure_events.reset()
    elastic.note_rebuilt_world()
    grown = [e for e in failure_events.snapshot()
             if e["kind"] == "world_grown"]
    assert len(grown) == 1 and grown[0]["new_members"] == [0, 7]


def test_note_rebuilt_world_unchanged_membership_records_nothing(
        monkeypatch, tmp_path):
    """A same-membership relaunch (a spurious yield) is not a topology
    change; the metrics stream stays quiet."""
    _grow_env(monkeypatch, tmp_path, gen=1, members="0,1")
    monkeypatch.setenv(PREV_ENV, "0,1")
    failure_events.reset()
    elastic.note_rebuilt_world()
    assert [e for e in failure_events.snapshot()
            if e["kind"] in ("world_grown", "world_shrunk")] == []


# -- the reshard event's direction label -------------------------------------


def test_cross_world_resume_labels_direction(monkeypatch):
    from pytorch_distributed_mnist_tpu_torch import cli

    for saved_procs, direction in ((1, "grow"), (4, "shrink")):
        failure_events.reset()
        monkeypatch.setattr(cli, "process_count", lambda: 2)
        monkeypatch.setattr(
            cli, "checkpoint_world",
            lambda path, _n=saved_procs: {"processes": _n, "devices": _n})
        cli._note_cross_world_resume("ckpt_x.npz")
        (event,) = [e for e in failure_events.snapshot()
                    if e["kind"] == "checkpoint_reshard"]
        assert event["direction"] == direction, direction
        assert direction in event["detail"]


def test_cross_world_resume_same_world_records_nothing(monkeypatch):
    from pytorch_distributed_mnist_tpu_torch import cli

    failure_events.reset()
    monkeypatch.setattr(cli, "checkpoint_world",
                        lambda path: {"processes": 1, "devices": 1})
    cli._note_cross_world_resume("ckpt_x.npz")
    assert [e for e in failure_events.snapshot()
            if e["kind"] == "checkpoint_reshard"] == []


def test_checkpoint_world_reads_the_stamp(tmp_path):
    import torch

    from pytorch_distributed_mnist_tpu_torch.models import get_model
    from pytorch_distributed_mnist_tpu_torch.train import checkpoint
    from pytorch_distributed_mnist_tpu_torch.train.state import (
        create_train_state,
    )

    state = create_train_state(get_model("linear"), 0, torch.device("cpu"))
    path = checkpoint.save_checkpoint(state, epoch=0, best_acc=0.0,
                                      is_best=False, directory=str(tmp_path))
    assert checkpoint.checkpoint_world(path) == {"processes": 1,
                                                 "devices": 1}


# -- supervisor-side flag plumbing and validation ----------------------------


def test_strip_elastic_flags_covers_grow_flags():
    argv = ["--spawn", "3", "--elastic", "--elastic-grow",
            "--max-world", "4", "--model", "linear", "--max-world=2"]
    assert strip_elastic_flags(argv) == ["--spawn", "3", "--model",
                                         "linear"]


def test_supervise_validates_max_world():
    with pytest.raises(ValueError, match="max-world"):
        elastic.supervise(3, [], max_world=2)
    with pytest.raises(ValueError, match="max-world"):
        elastic.supervise(2, [], max_world=-1)


def test_cli_rejects_grow_flags_without_elastic():
    from pytorch_distributed_mnist_tpu_torch.cli import main

    with pytest.raises(SystemExit, match="require --elastic"):
        main(["--elastic-grow", "--spawn", "2", "--dataset", "synthetic"])
    with pytest.raises(SystemExit, match="require --elastic"):
        main(["--max-world", "4", "--dataset", "synthetic"])


def test_cli_rejects_max_world_below_spawn():
    from pytorch_distributed_mnist_tpu_torch.cli import main

    with pytest.raises(SystemExit, match="below the initial world"):
        main(["--elastic", "--spawn", "3", "--max-world", "2"])



# -- held to the JAX functions -------------------------------------------------


def _returncodes(n):
    return itertools.product([0, 1, 75, -9, None], repeat=n)


@pytest.mark.parametrize("nranks", [1, 2, 3])
def test_plan_next_world_equals_jaxs_on_every_outcome(nranks):
    for rcs in _returncodes(nranks):
        for k in range(nranks + 1):
            for records in itertools.combinations(range(nranks), k):
                assert plan_next_world(nranks, list(rcs), records) == \
                    jax_elastic.plan_next_world(nranks, list(rcs), records)


@pytest.mark.parametrize("max_world", [0, 1, 2, 3, 5])
def test_plan_grow_equals_jaxs(max_world):
    for members in ([0], [0, 2], [0, 1, 2], [3, 1]):
        for joins in ([], [1], [5, 1], [4, 4, 3], [0, 2, 6], [7, 8, 9]):
            assert plan_grow(members, joins, max_world) == \
                jax_elastic.plan_grow(members, joins, max_world)


def test_records_and_codes_match_the_references(tmp_path):
    assert (elastic.EXIT_FLOOR, elastic.EXIT_GROW) == (
        jax_elastic.EXIT_FLOOR, jax_elastic.EXIT_GROW) == (78, 76)
    for name in ("DIR_ENV", "GEN_ENV", "MEMBERS_ENV", "PREV_ENV", "GROW_ENV",
                 "MAX_WORLD_ENV"):
        assert getattr(elastic, name) == getattr(jax_elastic, name)
    assert elastic.record_path("d", 3, 12) == jax_elastic.record_path(
        "d", 3, 12)
    assert join_path("d", 7) == jax_elastic.join_path("d", 7)
    announce_join(str(tmp_path), 4)
    assert jax_elastic.pending_joins(str(tmp_path)) == pending_joins(
        str(tmp_path))


def test_strip_flags_equal_jaxs():
    argv = ["--spawn", "3", "--elastic", "--min-world", "2",
            "--elastic-grow", "--max-world=4", "--resume", "auto",
            "--model", "linear"]
    assert strip_elastic_flags(argv) == jax_elastic.strip_elastic_flags(argv)
    assert elastic._strip_resume(argv) == jax_elastic._strip_resume(argv)


def test_supervise_refuses_more_ranks_than_cards(monkeypatch, tmp_path,
                                                 capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    rc = elastic.supervise(2, ["--model", "linear"], device="cuda",
                           rendezvous_dir=str(tmp_path))
    assert rc == 2
    assert "one card per rank" in capsys.readouterr().err
