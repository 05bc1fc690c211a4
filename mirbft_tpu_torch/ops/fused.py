"""Fused hash → verify → quorum-accumulate device wave.

One crypto wave without host round trips between its stages:

    blocks ──sha256──► digests ─┐ (device-resident, never leave the card)
                                ├─► digest-gated quorum accumulate
    sigs ───ed25519──► verdicts ┘       masks/counts updated in place

* **Digest handoff.** The quorum stage's touch rows can be *gated* on the
  wave's own digests: ``digest_rows[n, k]`` names a digest row of this wave
  (or of a chained earlier one) and ``claimed[n, k, :]`` the digest words the
  ack claims; a touch only counts when the freshly computed digest matches.
* **One collect** copies digests, verdicts and post-counts to the host
  together; nothing before it waits for the card.

The JAX package runs the three stages as one jitted program.  The port
enqueues them on the current CUDA stream, in order: one copy of the
staged wave in (its raw bytes and row index, the quorum stream and the
verify inputs, all in one pinned buffer: ``ops/pack.py``), the pack kernel
that writes the wave's layout (``csrc/pack.cu``), the
SHA-256 kernel the packed layout resolves to (``csrc/sha256.cu``; a lanes
wave is then permuted to one digest row per message, as the JAX program
does outside its Pallas kernel), the Ed25519 verify kernel when the wave
has signed rows (``csrc/ed25519.cu``), and always the gate and accumulate
kernel (``csrc/quorum.cu``), so that padding rows' posts are the JAX
program's; then one CUDA event.  ``prev_words`` (a chained wave's digests)
is only read, so a chained handle's digests stay collectable.

``host_fused_reference`` is the bit-exactness oracle, copied from the JAX
package: hashlib + the pure-Python RFC 8032 verifier +
``quorum.host_accumulate`` with identical gating.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from . import quorum as quorum_ops
from .quorum import MASK_WORDS, host_accumulate
from .pack import StagedWave
from .sha256 import DeviceWords, TorchHasher, digests_from_words

# The staged sections of a fused wave beside the hash wave's own: the
# quorum stream (``_pack_quorum``'s arrays, in its order) and the verify
# inputs (``Ed25519BatchVerifier.pack_inputs``' five arrays).
QUORUM_SECTIONS = ("sources", "touches", "valid", "digest_rows", "claimed", "touch_groups")
VERIFY_SECTIONS = ("ax", "ay", "r_bytes", "s_bits", "h_bits")
# The hash wave's own sections, which the pack kernel reads by pointer.
_HASH_SECTIONS = ("raw", "offsets", "lengths")


def _metrics():
    from .. import metrics

    return metrics


def _next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def _hash_stage(blocks, n_blocks, layout: str):
    """Digest words [B, 8] (int32 bits) for either packed layout,
    device-resident."""
    if layout == "lanes":
        from .sha256_pallas_lanes import TILE, sha256_lanes

        out = sha256_lanes(blocks, n_blocks)
        tiles = out.shape[0]
        # [tiles, 8, 8, 128] -> [tiles*1024, 8] so the quorum gate can index
        # digests by message row (the JAX program's transpose).
        return out.permute(0, 2, 3, 1).reshape(tiles * TILE, 8).contiguous()
    from .sha256_pallas import sha256_batch

    return sha256_batch(blocks, n_blocks)


class FusedDispatch:
    """One in-flight fused wave.  ``words`` mirrors ``HashDispatch.words``
    (a ``DeviceWords``: the [rows, 8] digest words on the device and the
    wave's event, so plane polling code treats either handle identically);
    ``ok`` / ``posts`` / ``newbits`` are the verify and quorum outputs, all
    still on the device until ``FusedCryptoPipeline.collect`` (or partially,
    via ``collect_ready``, which leaves the digest words resident so the
    handle can keep feeding chained waves)."""

    __slots__ = (
        "words", "count", "rows", "layout", "lease",
        "ok", "valid", "verify_count",
        "posts", "newbits", "auth_keys", "auth_items",
        "chain", "row_map", "groups",
    )

    def __init__(self, words, count, rows, layout, lease, ok, valid,
                 verify_count, posts, newbits, chain=None, groups=None):
        self.words = words
        self.count = count
        # Padded device row count — the chained row space the NEXT wave's
        # quorum gates index this wave's digests through.
        self.rows = rows
        self.layout = layout
        self.lease = lease
        self.ok = ok  # [V] bool on the device, or None for an unsigned wave
        self.valid = valid
        self.verify_count = verify_count
        self.posts = posts
        self.newbits = newbits
        # Auth-plane bookkeeping attached by DeviceHashPlane's fused path.
        self.auth_keys = None
        self.auth_items = None
        # The chained previous wave (kept alive: its words feed this
        # wave's gate) and the plane's surviving-row bookkeeping after
        # partial collects.
        self.chain = chain
        self.row_map = None
        # Per-row owning group over the padded row space (int32 [rows]);
        # chained successor waves concatenate this when building their
        # combined row-group column.
        self.groups = groups


class FusedResult:
    __slots__ = ("digests", "verdicts", "posts", "newbits")

    def __init__(self, digests, verdicts, posts, newbits):
        self.digests = digests  # List[bytes], input order
        self.verdicts = verdicts  # np.bool_ [V]
        self.posts = posts  # np.int32 [N, K]
        self.newbits = newbits  # np.bool_ [N, K]


class FusedCryptoPipeline:
    """Device-resident crypto pipeline: one dispatch + one collect per wave.

    Owns the quorum plane state (``masks [W, D, 8]`` / ``counts [W, D]``,
    int32 tensors on ``device``, updated in place by every dispatch), the
    pooled hash packer (via an internal ``TorchHasher``) and the verify
    packer (via an ``Ed25519BatchVerifier``).  A wave without signed rows
    launches no verify kernel; a wave without quorum entries still runs one
    all-invalid touch wave, as the JAX program does.

    ``n_groups`` makes the pipeline multi-tenant: the quorum plane grows to
    ``n_groups`` stacked per-group slabs (group ``g``'s slot ``w`` lives at
    row ``g * n_slots + w``), quorum entries may carry a leading group id
    (``(group, source, rows)``), and every digest row is tagged with its
    owning group so gates stay closed across tenants.  One-group callers see
    the single-tenant behaviour.

    ``device``: "cuda" (the default) launches the CUDA kernels, "cpu" runs
    their plain PyTorch twins.
    """

    def __init__(
        self,
        n_slots: int = 256,
        n_digest_slots: int = 4,
        kernel: str = "auto",
        touch_k: int = 8,
        verify_kernel: str = "auto",
        n_groups: int = 1,
        device="cuda",
    ):
        import torch

        from .ed25519 import Ed25519BatchVerifier

        self.touch_k = touch_k
        self.n_slots = n_slots
        self.n_groups = n_groups
        self.hasher = TorchHasher(min_device_batch=1, kernel=kernel, device=device)
        self.device = self.hasher.device
        # ``verify_kernel``: the Ed25519 field-multiply backend ("auto"
        # resolves through ops/crossover.py: on the card when the verifier
        # is built, on the CPU at dispatch time).
        self.verifier = Ed25519BatchVerifier(
            min_device_batch=1, kernel=verify_kernel, device=device
        )
        self.masks = torch.zeros(
            (n_groups * n_slots, n_digest_slots, MASK_WORDS),
            dtype=torch.int32, device=self.device,
        )
        self.counts = torch.zeros(
            (n_groups * n_slots, n_digest_slots), dtype=torch.int32, device=self.device
        )

    def resolved_verify_kernel(self) -> str:
        """The verify backend fused dispatches launch: explicit settings
        pass through, "auto" applies the crossover's resolution."""
        return self.verifier.resolved_kernel()

    # -- host-side packing helpers ------------------------------------------

    def _pack_quorum(
        self, quorum, total_rows: int, row_offset: int = 0
    ):
        """(sources, touches, valid, digest_rows, claimed, touch_groups)
        fixed-shape arrays from
        ``[(source, [(w, d, digest_row, claimed_digest|None)])]`` or the
        group-tagged ``[(group, source, rows)]`` form (the two may mix —
        an untagged entry is group 0).

        ``total_rows`` is the caller-visible gated row space; the device
        program prepends ``prev_words`` before indexing, so unchained
        waves shift every gated row past the one-row dummy
        (``row_offset=1``) while chained waves pass rows through
        (``row_offset=0`` — the combined [chain; current] space IS the
        device space).  Group-tagged entries land in their group's slab:
        slot ``w`` is offset to ``group * n_slots + w`` host-side, and the
        entry's group rides along as the touch's group tag for the
        device-side cross-tenant gate check."""
        k = self.touch_k
        n = _next_pow2(len(quorum)) if quorum else 1
        sources = np.zeros(n, dtype=np.int32)
        touches = np.zeros((n, k, 2), dtype=np.int32)
        valid = np.zeros((n, k), dtype=bool)
        digest_rows = np.full((n, k), -1, dtype=np.int32)
        claimed = np.zeros((n, k, 8), dtype=np.uint32)
        touch_groups = np.zeros((n, k), dtype=np.int32)
        for i, entry in enumerate(quorum):
            if len(entry) == 3:
                group, source, rows = entry
            else:
                group, (source, rows) = 0, entry
            if not 0 <= group < self.n_groups:
                raise ValueError(
                    f"group {group} outside pipeline of {self.n_groups}"
                )
            if len(rows) > k:
                raise ValueError(f"wave {i} exceeds K={k} touches")
            sources[i] = source
            for j, (w, d, row, claim) in enumerate(rows):
                if self.n_groups > 1 and not 0 <= w < self.n_slots:
                    # Multi-tenant slabs are adjacent: an out-of-range slot
                    # would land in a neighbor group's rows, so it is an
                    # error rather than the single-tenant clip-to-edge.
                    raise ValueError(
                        f"slot {w} outside group slab of {self.n_slots}"
                    )
                touches[i, j] = (group * self.n_slots + w, d)
                valid[i, j] = True
                touch_groups[i, j] = group
                if row is not None and row >= 0:
                    if row >= total_rows:
                        raise ValueError(
                            f"digest row {row} outside wave of {total_rows}"
                        )
                    digest_rows[i, j] = row + row_offset
                    claimed[i, j] = np.frombuffer(
                        claim, dtype=">u4"
                    ).astype(np.uint32)
        return sources, touches, valid, digest_rows, claimed, touch_groups

    # -- dispatch / collect --------------------------------------------------

    def dispatch_wave(
        self,
        messages: Sequence[bytes],
        signed: Optional[Tuple[Sequence[bytes], Sequence[bytes], Sequence[bytes]]] = None,
        quorum: Optional[Sequence] = None,
        block_bucket: Optional[int] = None,
        batch_bucket: Optional[int] = None,
        packed: Optional[StagedWave] = None,
        chain: Optional[FusedDispatch] = None,
        groups: Optional[Sequence[int]] = None,
    ) -> FusedDispatch:
        """One wave's three stages, enqueued on the current stream.

        ``messages`` (or a pre-``pack``ed wave) feed the hash stage;
        ``signed`` is the verify stage's (pubs, msgs, sigs); ``quorum`` is a
        wave stream ``[(source, [(slot, digest_slot, digest_row|None,
        claimed_digest)])]`` — or group-tagged ``[(group, source, rows)]``
        in a multi-tenant pipeline — whose gated touches compare against
        this very wave's digests.  Returns without waiting for the card.

        ``groups`` tags message row ``i`` with its owning group id; ``None``
        means every row belongs to group 0 (the single-tenant wave).

        ``chain`` threads the PREVIOUS wave's device-resident digest words
        into this wave's gate: gated ``digest_row``s then index the
        combined row space — rows ``[0, chain.rows)`` are the previous
        wave's digests (still on the card, never collected), rows from
        ``chain.rows`` are this wave's."""
        if packed is None:
            packed = self.hasher.pack(messages, block_bucket, batch_bucket)
        batch_rows = packed.batch
        # Per-row group column over the padded row space.  Untagged waves
        # are all group 0, padding included; tagged waves mark padding rows
        # -1 — fail-closed against a gate that references a padding row
        # across groups.
        if groups is None:
            cur_groups = np.zeros(batch_rows, dtype=np.int32)
        else:
            if len(groups) > batch_rows:
                raise ValueError("more group tags than wave rows")
            cur_groups = np.full(batch_rows, -1, dtype=np.int32)
            cur_groups[: len(groups)] = np.asarray(groups, dtype=np.int32)
        if chain is not None:
            if chain.words is None:
                raise ValueError("chained handle's digests were released")
            prev_words = chain.words.tensor
            row_offset = 0
            total_rows = chain.rows + batch_rows
            prev_groups = (
                chain.groups
                if chain.groups is not None
                else np.zeros(chain.rows, dtype=np.int32)
            )
        else:
            prev_words = None
            row_offset = 1
            total_rows = batch_rows
            # The dummy row gates closed for every group when tags are in
            # play; group 0 when untagged (its zero digest words never
            # equal a real claim anyway).
            prev_groups = np.zeros(1, dtype=np.int32)
            if groups is not None:
                prev_groups = np.full(1, -1, dtype=np.int32)
        row_groups = np.concatenate([prev_groups, cur_groups])

        verify_names = ()
        if signed and len(signed[0]):
            pubs, vmsgs, sigs = signed
            *verify_inputs, valid = self.verifier.pack_inputs(pubs, vmsgs, sigs)
            verify_count = len(pubs)
            verify_names = VERIFY_SECTIONS
            for name, arr in zip(verify_names, verify_inputs):
                packed.add(name, arr)
        else:
            valid = np.zeros(1, dtype=bool)
            verify_count = 0

        quorum_arrays = self._pack_quorum(quorum or [], total_rows, row_offset)
        for name, arr in zip(QUORUM_SECTIONS, quorum_arrays):
            packed.add(name, arr)
        packed.add("row_groups", row_groups)
        if prev_words is None:
            # The one-row dummy digest, zero, rides the staged copy.
            packed.reserve("prev_words", np.int32, (1, 8))[...] = 0
        backend = self.verifier.resolved_kernel()

        import torch

        dev = self.device
        start = time.perf_counter()
        # One copy of the whole staged wave, then the pack kernel.
        flat = packed.copy_in(dev)
        staged = packed.views(flat, [k for k in packed.sections if k not in _HASH_SECTIONS])
        blocks, n_blocks = packed.pack(flat)
        if prev_words is None:
            prev_words = staged["prev_words"]
        digests = _hash_stage(blocks, n_blocks, packed.layout)
        ok = None
        if verify_names:
            from .ed25519 import ed25519_verify_kernel

            ok = ed25519_verify_kernel(*(staged[k] for k in verify_names), backend=backend)
        posts, newbits = quorum_ops.quorum_accumulate(
            self.masks, self.counts, staged["sources"], staged["touches"], staged["valid"],
            (prev_words, digests, staged["digest_rows"], staged["claimed"],
             staged["row_groups"], staged["touch_groups"]),
        )
        event = None
        if dev.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(dev))
            # The staged buffer is reused only once this event is done.
            packed.lease.event = event
        m = _metrics()
        m.histogram("hash_device_dispatch_seconds").observe(
            time.perf_counter() - start
        )
        m.counter("fused_wave_dispatches").inc()
        m.counter("fused_wave_messages").inc(packed.count)
        if batch_rows:
            m.gauge("fused_wave_occupancy").set(packed.count / batch_rows)
        return FusedDispatch(
            DeviceWords(digests, event), packed.count, batch_rows, packed.layout,
            packed.lease, ok, valid, verify_count, posts, newbits, chain=chain,
            groups=cur_groups,
        )

    def _verdicts(self, handle: FusedDispatch) -> np.ndarray:
        if handle.ok is None:
            return np.zeros(0, dtype=bool)
        return (
            handle.ok.cpu().numpy()[: handle.verify_count]
            & handle.valid[: handle.verify_count]
        )

    def collect(self, handle: FusedDispatch) -> FusedResult:
        """One wait for all three stages' outputs; releases the pooled
        packing lease."""
        words = handle.words.tensor.cpu().numpy().view(np.uint32)
        verdicts = self._verdicts(handle)
        posts = handle.posts.cpu().numpy()
        newbits = handle.newbits.cpu().numpy()
        digests = digests_from_words(words[: handle.count])
        self._release_lease(handle)
        handle.chain = None  # full collect: stop pinning the chained wave
        return FusedResult(digests, verdicts, posts, newbits)

    def collect_ready(
        self, handle: FusedDispatch, rows: Sequence[int]
    ) -> FusedResult:
        """Partial collect: copy ONLY the commit-ready digest rows
        (current-wave indices, result order follows ``rows``) plus the
        wave's verdicts and quorum posts.  The digest words stay on the
        card — the handle remains valid both for later
        ``collect_ready``/``collect`` calls and as the ``chain`` input of
        the next wave, so non-ready digests never cross to the host."""
        import torch

        idx = np.asarray(list(rows), dtype=np.int64)
        if idx.size:
            if idx.min() < 0 or idx.max() >= handle.count:
                raise ValueError(
                    f"rows outside the wave's {handle.count} messages"
                )
            tensor = handle.words.tensor
            picked = tensor[torch.from_numpy(idx).to(tensor.device)]
            words = picked.cpu().numpy().view(np.uint32)
        else:
            words = np.zeros((0, 8), dtype=np.uint32)
        verdicts = self._verdicts(handle)
        posts = handle.posts.cpu().numpy()
        newbits = handle.newbits.cpu().numpy()
        digests = digests_from_words(words)
        # The wave has necessarily run by now (its outputs just reached
        # the host), so the packed slab is consumed and the pooled lease
        # can be returned even though the words stay resident.
        self._release_lease(handle)
        _metrics().counter("fused_partial_collects").inc()
        return FusedResult(digests, verdicts, posts, newbits)

    def _release_lease(self, handle: FusedDispatch) -> None:
        if handle.lease is not None:
            self.hasher._pool.release(handle.lease)
            handle.lease = None

    def quorum_state(self) -> Tuple[np.ndarray, np.ndarray]:
        """The device-resident (masks uint32, counts int32) on the host — a
        blocking copy; steady-state consumers should read per-wave
        ``posts``."""
        return (
            self.masks.cpu().numpy().view(np.uint32),
            self.counts.cpu().numpy(),
        )


def host_fused_reference(
    messages: Sequence[bytes],
    signed: Optional[Tuple[Sequence[bytes], Sequence[bytes], Sequence[bytes]]],
    quorum: Optional[Sequence],
    masks: np.ndarray,
    counts: np.ndarray,
    touch_k: int = 8,
    prev_digests: Optional[Sequence[bytes]] = None,
    prev_rows: Optional[int] = None,
    groups: Optional[Sequence[int]] = None,
    prev_groups: Optional[Sequence[int]] = None,
    n_slots: Optional[int] = None,
) -> Tuple[List[bytes], np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Pure-host oracle for the fused wave: hashlib digests, RFC 8032
    verdicts, and numpy quorum accumulation with identical digest gating.
    Returns (digests, verdicts, masks, counts, posts, newbits).

    ``prev_digests`` models a chained wave: gated rows then index the
    combined [previous wave; this wave] row space, with the previous wave
    occupying rows ``[0, prev_rows)`` (``prev_rows`` defaults to
    ``len(prev_digests)``; pass the chained handle's padded ``rows`` when
    mirroring device padding).  Rows in the padding gap gate closed, like
    the device's zero-padded digest rows never matching a real claim.

    The multi-tenant wave is mirrored too: ``groups`` tags message ``i``
    with its group (default: all group 0), ``prev_groups`` the chained
    rows, and quorum entries may be group-tagged ``(group, source, rows)``
    — the entry's slots land at ``group * n_slots`` in the stacked slab
    (``n_slots`` is required for tagged entries) and a gate only opens
    when the referenced row's group equals the entry's group."""
    import hashlib

    from .ed25519 import verify_one

    digests = [hashlib.sha256(m).digest() for m in messages]
    row_tags = list(groups) if groups is not None else [0] * len(messages)
    if len(row_tags) != len(messages):
        raise ValueError("groups must tag every message")
    prev = list(prev_digests or [])
    prev_tags = list(prev_groups) if prev_groups is not None else [0] * len(prev)
    offset = len(prev) if prev_rows is None else prev_rows
    if signed and len(signed[0]):
        verdicts = np.array(
            [verify_one(p, m, s) for p, m, s in zip(*signed)], dtype=bool
        )
    else:
        verdicts = np.zeros(0, dtype=bool)

    quorum = quorum or []
    k = touch_k
    n = _next_pow2(len(quorum)) if quorum else 1
    sources = np.zeros(n, dtype=np.int32)
    touches = np.zeros((n, k, 2), dtype=np.int32)
    valid = np.zeros((n, k), dtype=bool)
    for i, entry in enumerate(quorum):
        if len(entry) == 3:
            group, source, rows = entry
            if n_slots is None:
                raise ValueError("group-tagged quorum entries need n_slots")
            slot_base = group * n_slots
        else:
            group, (source, rows) = 0, entry
            slot_base = 0
        sources[i] = source
        for j, (w, d, row, claim) in enumerate(rows):
            touches[i, j] = (slot_base + w, d)
            gate_ok = True
            if row is not None and row >= 0:
                if row < offset:
                    gate_ok = (
                        row < len(prev)
                        and prev[row] == claim
                        and prev_tags[row] == group
                    )
                else:
                    r = row - offset
                    gate_ok = digests[r] == claim and row_tags[r] == group
            valid[i, j] = gate_ok
    masks, counts, posts, newbits = host_accumulate(
        masks, counts, sources, touches, valid
    )
    return digests, verdicts, masks, counts, posts, newbits
