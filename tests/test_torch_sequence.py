"""The port's sequence against the reference's, where they differ.

A follower's batch digest can arrive after the owner's Commit (its hashing
lags the network).  The owner's Commit already counted its vote, so the
digest's implicit owner prepare is a duplicate.  The reference drops it and
returns, and the READY sequence never sends its Prepare: it waits for an
epoch change.  The port advances it.  Every other ordering emits the
reference's actions exactly, on the native vote plane and on the
pure-Python masks.
"""

import struct

import pytest

from mirbft_tpu import _native as ref_native
from mirbft_tpu import messages as ref_m
from mirbft_tpu.config import standard_initial_network_state as ref_network_state
from mirbft_tpu.statemachine.persisted import PersistedLog as RefPersistedLog
from mirbft_tpu.statemachine.sequence import Sequence as RefSequence
from mirbft_tpu_torch import _native
from mirbft_tpu_torch import messages as m
from mirbft_tpu_torch import state as st
from mirbft_tpu_torch.config import standard_initial_network_state
from mirbft_tpu_torch.statemachine.persisted import PersistedLog
from mirbft_tpu_torch.statemachine.sequence import SeqState, Sequence
from mirbft_tpu_torch.statemachine.stateless import intersection_quorum

NODES = (0, 1, 2, 3)
DIGEST = b"d" * 32
SEQ_NO = 5
EPOCH = 4


def _plane(native, network_config, my_id):
    plane = native.core.SeqPlane(
        len(NODES), my_id, intersection_quorum(network_config)
    )
    plane.reset(EPOCH, 10_000, struct.pack("<4i", *NODES))
    plane.set_window(1, 20)
    return plane


def _sequence(pkg, use_plane, my_id=1, owner=0):
    msgs, network_state, log_cls, seq_cls, native = pkg
    state = network_state(len(NODES), 0)
    log = log_cls()
    log.append_initial_load(
        1, msgs.CEntry(seq_no=0, checkpoint_value=b"genesis", network_state=state)
    )
    log.append_initial_load(
        2, msgs.FEntry(ends_epoch_config=msgs.EpochConfig(0, NODES, 0))
    )
    plane = _plane(native, state.config, my_id) if use_plane else None
    return seq_cls(
        owner=owner,
        epoch=EPOCH,
        seq_no=SEQ_NO,
        persisted=log,
        network_config=state.config,
        my_id=my_id,
        plane=plane,
    )


PORT = (m, standard_initial_network_state, PersistedLog, Sequence, _native)
REF = (ref_m, ref_network_state, RefPersistedLog, RefSequence, ref_native)
PATHS = pytest.mark.parametrize(
    "use_plane",
    [
        pytest.param(
            True,
            marks=pytest.mark.skipif(
                not (_native.available and ref_native.available),
                reason="native extension unavailable",
            ),
            id="plane",
        ),
        pytest.param(False, id="masks"),
    ],
)


def _acks(msgs):
    return [
        msgs.RequestAck(client_id=9, req_no=n, digest=bytes([n]) * 32) for n in (7, 8)
    ]


@PATHS
def test_digest_after_owner_commit_sends_the_prepare(use_plane):
    s = _sequence(PORT, use_plane)
    acks = _acks(m)
    s.allocate(acks, None)
    assert s.state == SeqState.READY
    assert list(s.apply_commit_msg(0, DIGEST)) == []
    actions = list(s.apply_batch_hash_result(DIGEST))
    q_entry = m.QEntry(seq_no=SEQ_NO, digest=DIGEST, requests=tuple(acks))
    assert actions == [
        st.ActionPersist(index=3, entry=q_entry),
        st.ActionSend(
            targets=NODES, msg=m.Prepare(seq_no=SEQ_NO, epoch=EPOCH, digest=DIGEST)
        ),
    ]
    assert s.state == SeqState.PREPREPARED
    # As in the reference, the owner's Commit is no prepare vote and its
    # later prepare is a duplicate: ours and those of nodes 2 and 3 make
    # the quorum of 3.
    assert list(s.apply_prepare_msg(1, DIGEST)) == []
    assert list(s.apply_prepare_msg(0, DIGEST)) == []
    assert list(s.apply_prepare_msg(2, DIGEST)) == []
    assert s.state == SeqState.PREPREPARED
    actions = list(s.apply_prepare_msg(3, DIGEST))
    assert actions == [
        st.ActionPersist(index=4, entry=m.PEntry(seq_no=SEQ_NO, digest=DIGEST)),
        st.ActionSend(
            targets=NODES, msg=m.Commit(seq_no=SEQ_NO, epoch=EPOCH, digest=DIGEST)
        ),
    ]
    assert s.state == SeqState.PREPARED


@PATHS
def test_reference_waits_for_an_epoch_change_there(use_plane):
    """The fault the port repairs: the reference's sequence stays READY."""
    s = _sequence(REF, use_plane)
    s.allocate(_acks(ref_m), None)
    s.apply_commit_msg(0, DIGEST)
    assert list(s.apply_batch_hash_result(DIGEST)) == []
    assert s.state.name == "READY"


def _drive(pkg, use_plane, script):
    """Run ``script`` on a fresh sequence; each step's actions as reprs
    without the package name, and the final state's name."""
    msgs = pkg[0]
    s = _sequence(pkg, use_plane)
    out = []
    for step, *args in script:
        if step == "allocate":
            actions = s.allocate(_acks(msgs), None)
        else:
            actions = getattr(s, step)(*args)
        out.append(repr(list(actions)).replace("mirbft_tpu_torch", "mirbft_tpu"))
    return out, s.state.name


SCRIPTS = {
    "digest_first": [
        ("allocate",),
        ("apply_batch_hash_result", DIGEST),
        ("apply_prepare_msg", 1, DIGEST),
        ("apply_commit_msg", 0, DIGEST),
        ("apply_prepare_msg", 2, DIGEST),
        ("apply_commit_msg", 1, DIGEST),
        ("apply_commit_msg", 2, DIGEST),
    ],
    "prepares_before_digest": [
        ("allocate",),
        ("apply_prepare_msg", 2, DIGEST),
        ("apply_prepare_msg", 3, DIGEST),
        ("apply_batch_hash_result", DIGEST),
        ("apply_prepare_msg", 1, DIGEST),
    ],
    "owner_commit_after_digest": [
        ("allocate",),
        ("apply_batch_hash_result", DIGEST),
        ("apply_commit_msg", 0, DIGEST),
        ("apply_prepare_msg", 1, DIGEST),
        ("apply_prepare_msg", 2, DIGEST),
    ],
    "conflicting_digest": [
        ("allocate",),
        ("apply_prepare_msg", 2, b"e" * 32),
        ("apply_batch_hash_result", DIGEST),
        ("apply_prepare_msg", 1, DIGEST),
        ("apply_prepare_msg", 3, DIGEST),
    ],
}


@PATHS
@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_other_orderings_match_the_reference(use_plane, script):
    assert _drive(PORT, use_plane, SCRIPTS[script]) == _drive(
        REF, use_plane, SCRIPTS[script]
    )
