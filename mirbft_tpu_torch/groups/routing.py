"""Client-routing tier for multi-group sharded consensus.

A sharded deployment runs S independent mirbft groups; each client is
homed to exactly one group by a stable hash of its client id
(:func:`group_for_client`).  The routing tier is deliberately thin:

* :class:`GroupMap` — the authoritative ``group -> [(host, port), ...]``
  table, JSON-serializable so it can ride in MAP_REPLY frames and
  redirect replies.
* :class:`RoutedClient` — a route-aware socket client.  One TCP
  connection per node address multiplexes submissions to every group the
  node co-hosts (the KIND_CLIENT group envelope, ``net/framing.py``); a
  submission that lands on a node not hosting the client's group earns a
  ``CLIENT_REDIRECT`` reply carrying the current group map, which the
  client installs before retrying — so a stale or empty map self-heals
  in one round trip.

Rebalancing is live (docs/SHARDING.md "Elastic resharding"): every map
carries a monotonically increasing ``map_version`` and a per-group
**route** — a ``(modulus, residue)`` pair over the client hash — so a
split refines one group's key range in place (parent ``(m, r)`` becomes
``(2m, r)`` plus a child at ``(2m, r+m)``; the nesting is exact because
``h mod 2m ≡ h mod m (mod m)``) and a merge reverses it.  Group ids
survive retirement: after a merge the id set may be sparse, and the
dense view lives in :attr:`GroupMap.active_groups`.
"""

from __future__ import annotations

import hashlib
import json
import socket
import struct
import time
from fractions import Fraction
from math import gcd
from typing import Dict, List, Optional, Tuple

from .. import metrics as metrics_mod
from ..net.framing import (
    KIND_CLIENT,
    KIND_GROUP,
    FrameDecoder,
    encode_client_envelope,
    encode_frame,
)

# Client submission bodies: 8-byte big-endian req_no + opaque request
# data.  Replies are a 1-byte status, except redirects which append the
# serialized group map after the status byte.
CLIENT_REQ = struct.Struct(">Q")
CLIENT_BUSY = b"\x00"
CLIENT_OK = b"\x01"
CLIENT_REDIRECT = b"\x02"

_HASH_INPUT = struct.Struct(">Q")


def client_hash(client_id: int) -> int:
    """The routing hash integer: sha256 of the 8-byte big-endian client
    id, first 8 digest bytes as an unsigned int.  Deterministic across
    processes and Python versions (never ``hash()``); routes partition
    its residues."""
    digest = hashlib.sha256(_HASH_INPUT.pack(client_id)).digest()
    return int.from_bytes(digest[:8], "big")


def group_for_client(client_id: int, num_groups: int) -> int:
    """Stable dense routing hash (:func:`client_hash` mod the group
    count) — the pre-resharding route shape, still what a fresh dense
    deployment uses, uniform enough that client populations spread
    evenly."""
    if num_groups < 1:
        raise ValueError(f"num_groups must be >= 1, got {num_groups}")
    return client_hash(client_id) % num_groups


_TRACE_INPUT = struct.Struct(">QQ")


def trace_id_for(client_id: int, req_no: int) -> int:
    """Deterministic nonzero u64 fleet trace id for one client request.

    Derived (sha256 over the identity, low bit forced) rather than drawn
    at random so the id survives redirects and resubmission without any
    coordination — every retry of the same request stamps the same id,
    and tests can predict it (docs/OBSERVABILITY.md "Fleet plane")."""
    digest = hashlib.sha256(
        b"trace" + _TRACE_INPUT.pack(client_id, req_no)
    ).digest()
    return int.from_bytes(digest[:8], "big") | 1


def client_for_group(group_id: int, num_groups: int, start: int = 0) -> int:
    """Smallest client id >= ``start`` that hashes to ``group_id`` —
    the deployment harness picks per-group client identities with it."""
    cid = start
    while group_for_client(cid, num_groups) != group_id:
        cid += 1
        if cid - start > 100_000:
            raise RuntimeError(
                f"no client id for group {group_id}/{num_groups} "
                f"within 100k of {start}"
            )
    return cid


class GroupMap:
    """``group -> [(host, port), ...]`` plus an epoch version and routes.

    * ``map_version`` — monotonically increasing; every cutover bumps it,
      and it rides in the JSON wire form, MAP_REPLY frames, and redirect
      replies so routers and clients can distinguish stale from current
      assignments.
    * ``routes`` — ``group -> (modulus, residue)`` over
      :func:`client_hash`.  Defaults to the dense assignment (the group
      at rank ``i`` of ``active_groups`` owns ``(S, i)``), which is
      byte-identical in wire form to the pre-versioning map, so legacy
      decoders and recorded streams keep working.  Explicit routes must
      partition the hash space: pairwise CRT-incompatible and covering
      residue mass exactly 1.

    Group ids need not be dense: a merge retires an id, and the sorted
    live view is :attr:`active_groups` (``num_groups`` stays its length).
    """

    def __init__(
        self,
        addrs: Dict[int, List[Tuple[str, int]]],
        map_version: int = 0,
        routes: Optional[Dict[int, Tuple[int, int]]] = None,
    ):
        if not addrs:
            raise ValueError("GroupMap needs at least one group")
        self.addrs = {
            int(g): [(str(h), int(p)) for h, p in members]
            for g, members in addrs.items()
        }
        self.active_groups = sorted(self.addrs)
        self.num_groups = len(self.addrs)
        self.map_version = int(map_version)
        if self.map_version < 0:
            raise ValueError(f"map_version must be >= 0, got {map_version}")
        if routes is None:
            routes = self._dense_routes()
        self.routes = {
            int(g): (int(m), int(r)) for g, (m, r) in routes.items()
        }
        self._validate_routes()

    def _dense_routes(self) -> Dict[int, Tuple[int, int]]:
        return {
            g: (self.num_groups, i)
            for i, g in enumerate(self.active_groups)
        }

    def _validate_routes(self) -> None:
        if sorted(self.routes) != self.active_groups:
            raise ValueError(
                f"routes cover {sorted(self.routes)}, "
                f"groups are {self.active_groups}"
            )
        for g, (m, r) in self.routes.items():
            if m < 1 or not 0 <= r < m:
                raise ValueError(f"group {g} route ({m}, {r}) malformed")
        # Disjointness: residues (m1, r1) and (m2, r2) share a hash iff
        # r1 ≡ r2 (mod gcd(m1, m2)); coverage: residue mass sums to 1.
        items = sorted(self.routes.items())
        for i, (g1, (m1, r1)) in enumerate(items):
            for g2, (m2, r2) in items[i + 1:]:
                if (r1 - r2) % gcd(m1, m2) == 0:
                    raise ValueError(
                        f"groups {g1} and {g2} routes overlap: "
                        f"({m1}, {r1}) vs ({m2}, {r2})"
                    )
        mass = sum(Fraction(1, m) for m, _r in self.routes.values())
        if mass != 1:
            raise ValueError(
                f"routes cover {mass} of the hash space, need exactly 1"
            )

    def members(self, group_id: int) -> List[Tuple[str, int]]:
        return list(self.addrs[group_id])

    def group_for(self, client_id: int) -> int:
        """The group whose route owns this client's hash residue."""
        h = client_hash(client_id)
        for g, (m, r) in self.routes.items():
            if h % m == r:
                return g
        raise AssertionError(
            f"validated routes failed to cover hash {h}"
        )  # pragma: no cover - _validate_routes guarantees coverage

    def bump(self, **kwargs) -> "GroupMap":
        """A copy with ``map_version + 1``; ``addrs``/``routes`` override."""
        return GroupMap(
            kwargs.get("addrs", self.addrs),
            map_version=self.map_version + 1,
            routes=kwargs.get("routes", self.routes),
        )

    def split_group(
        self,
        parent: int,
        child: int,
        child_members: List[Tuple[str, int]],
    ) -> "GroupMap":
        """Refine ``parent``'s route in place: parent ``(m, r)`` becomes
        ``(2m, r)``, the new ``child`` takes ``(2m, r+m)``.  Exact
        nesting — every client either stays or moves to the child, no
        third party is touched.  Returns a ``map_version + 1`` map."""
        if child in self.addrs:
            raise ValueError(f"child group id {child} already in the map")
        m, r = self.routes[parent]
        addrs = dict(self.addrs)
        addrs[child] = list(child_members)
        routes = dict(self.routes)
        routes[parent] = (2 * m, r)
        routes[child] = (2 * m, r + m)
        return GroupMap(addrs, self.map_version + 1, routes)

    def merge_group(self, child: int, parent: int) -> "GroupMap":
        """Reverse of :meth:`split_group`: the child's residue half drains
        back into the parent, the child id retires (the id set may go
        sparse — ``active_groups`` stays the dense view)."""
        mp, rp = self.routes[parent]
        mc, rc = self.routes[child]
        if mp != mc or mp % 2 or abs(rp - rc) != mp // 2:
            raise ValueError(
                f"groups {parent} ({mp}, {rp}) and {child} ({mc}, {rc}) "
                f"are not sibling halves of one split"
            )
        addrs = dict(self.addrs)
        del addrs[child]
        routes = dict(self.routes)
        del routes[child]
        routes[parent] = (mp // 2, rp % (mp // 2))
        return GroupMap(addrs, self.map_version + 1, routes)

    def to_json_bytes(self) -> bytes:
        # Version-0 dense maps keep the legacy wire form byte-identical
        # (old decoders, recorded MAP_REPLY streams); anything touched by
        # a reshard emits the versioned document.
        if self.map_version == 0 and self.routes == self._dense_routes():
            return json.dumps(
                {str(g): [[h, p] for h, p in m] for g, m in self.addrs.items()},
                sort_keys=True,
            ).encode()
        return json.dumps(
            {
                "map_version": self.map_version,
                "groups": {
                    str(g): {
                        "members": [[h, p] for h, p in self.addrs[g]],
                        "route": list(self.routes[g]),
                    }
                    for g in self.active_groups
                },
            },
            sort_keys=True,
        ).encode()

    @classmethod
    def from_json_doc(cls, doc: dict) -> "GroupMap":
        """Decode either wire document shape; a legacy document (no
        ``map_version``) is version 0 with dense routes."""
        if "map_version" in doc:
            groups = doc["groups"]
            return cls(
                {
                    int(g): [(h, int(p)) for h, p in spec["members"]]
                    for g, spec in groups.items()
                },
                map_version=int(doc["map_version"]),
                routes={
                    int(g): (int(spec["route"][0]), int(spec["route"][1]))
                    for g, spec in groups.items()
                },
            )
        return cls(
            {
                int(g): [(h, int(p)) for h, p in members]
                for g, members in doc.items()
            }
        )

    @classmethod
    def from_json_bytes(cls, data: bytes) -> "GroupMap":
        return cls.from_json_doc(json.loads(data.decode()))

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, GroupMap)
            and self.addrs == other.addrs
            and self.routes == other.routes
            and self.map_version == other.map_version
        )

    def __repr__(self) -> str:
        return (
            f"GroupMap({self.addrs!r}, map_version={self.map_version}, "
            f"routes={self.routes!r})"
        )


class RoutedClient:
    """Route-aware submission handle over the KIND_CLIENT plane.

    ``submit(client_id, req_no, data)`` routes the client to its home
    group under the current map, sends a group-enveloped frame to a
    member of that group, and interprets the three reply statuses: OK
    (committed to the protocol), BUSY (client window full — caller
    retries), REDIRECT (the node does not route that client to itself —
    install the attached map and retry another member).  Connections are
    cached per address and reused across groups, so a node co-hosting
    several groups sees one multiplexed connection, not one per group.

    Stale-map hardening (docs/SHARDING.md "Elastic resharding"): a
    redirect carrying a map whose ``map_version`` is *lower* than the
    installed one is never adopted — mid-cutover a lagging router still
    serves the previous epoch's map, and downgrading would bounce the
    client between epochs forever.  Such replies only count
    ``router_stale_map_redirects_total`` (and ``stale_redirects``) and
    cost one attempt; the total redirect chase per submission is capped
    at ``max_redirect_hops``.
    """

    def __init__(
        self,
        group_map: Optional[GroupMap] = None,
        bootstrap: Optional[Tuple[str, int]] = None,
        timeout_s: float = 15.0,
        attempts: int = 6,
        max_redirect_hops: int = 8,
        registry=None,
    ):
        if group_map is None and bootstrap is None:
            raise ValueError("RoutedClient needs a group map or a bootstrap addr")
        self.map = group_map
        self.timeout_s = timeout_s
        self.attempts = attempts
        self.max_redirect_hops = max_redirect_hops
        self.redirects_followed = 0
        self.stale_redirects = 0
        reg = registry if registry is not None else metrics_mod.default_registry
        self._stale_metric = reg.counter("router_stale_map_redirects_total")
        self._conns: Dict[Tuple[str, int], socket.socket] = {}
        self._decoders: Dict[Tuple[str, int], FrameDecoder] = {}
        if self.map is None:
            self.map = self.fetch_map(bootstrap)

    # -- connection cache --------------------------------------------------

    def _conn(self, addr: Tuple[str, int]) -> socket.socket:
        sock = self._conns.get(addr)
        if sock is None:
            sock = socket.create_connection(addr, timeout=self.timeout_s)
            self._conns[addr] = sock
            self._decoders[addr] = FrameDecoder()
        return sock

    def _drop(self, addr: Tuple[str, int]) -> None:
        sock = self._conns.pop(addr, None)
        self._decoders.pop(addr, None)
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    def _roundtrip(self, addr: Tuple[str, int], frame: bytes, kind: int) -> bytes:
        sock = self._conn(addr)
        decoder = self._decoders[addr]
        sock.sendall(frame)
        while True:
            chunk = sock.recv(65536)
            if not chunk:
                raise ConnectionError(f"{addr} closed the connection")
            for got_kind, payload in decoder.feed(chunk):
                if got_kind == kind:
                    return payload

    # -- map discovery -----------------------------------------------------

    def fetch_map(self, addr: Tuple[str, int]) -> GroupMap:
        """MAP_REQUEST/MAP_REPLY round trip against any sharded node."""
        from . import ship

        payload = self._roundtrip(
            addr, encode_frame(KIND_GROUP, ship.encode_map_request()), KIND_GROUP
        )
        subtype, _group, _seq, body = ship.decode(payload)
        if subtype != ship.MAP_REPLY:
            raise ConnectionError(
                f"{addr} answered MAP_REQUEST with subtype {subtype}"
            )
        return GroupMap.from_json_bytes(body)

    # -- submission --------------------------------------------------------

    def submit(
        self,
        client_id: int,
        req_no: int,
        data: bytes,
        member: Optional[int] = None,
    ) -> bool:
        """Submit one request; True iff accepted (OK), False on BUSY.
        ``member`` pins the submission to one group member index (the
        harness submits to every member — the reference stress shape);
        default rotates by attempt.  Redirect replies update the map and
        retry; connection errors rotate to the next member."""
        body = CLIENT_REQ.pack(req_no) + data
        # One id for the request's whole lifetime: redirects and retries
        # re-stamp the same value, so downstream spans always join.
        trace_id = trace_id_for(client_id, req_no)
        last_err: Optional[Exception] = None
        group_id = 0
        hops = 0
        for attempt in range(self.attempts):
            # Recomputed each attempt: a redirect may have replaced the
            # map (and with it the routes and membership).
            group_id = self.map.group_for(client_id)
            frame = encode_frame(
                KIND_CLIENT,
                encode_client_envelope(
                    group_id,
                    body,
                    trace_id=trace_id,
                    client_id=client_id,
                    map_version=self.map.map_version,
                ),
            )
            members = self.map.members(group_id)
            idx = member if member is not None else attempt
            addr = members[idx % len(members)]
            if attempt:
                time.sleep(min(1.0, 0.05 * (2 ** (attempt - 1))))
            try:
                status = self._roundtrip(addr, frame, KIND_CLIENT)
            except (OSError, ConnectionError) as err:
                last_err = err
                self._drop(addr)
                continue
            if status[:1] == CLIENT_REDIRECT:
                hops += 1
                if hops > self.max_redirect_hops:
                    raise ConnectionError(
                        f"redirect chase for client {client_id} exceeded "
                        f"{self.max_redirect_hops} hops"
                    )
                carried = GroupMap.from_json_bytes(status[1:])
                if carried.map_version < self.map.map_version:
                    # Stale router: never downgrade the installed epoch.
                    self.stale_redirects += 1
                    self._stale_metric.inc()
                    continue
                self.map = carried
                self.redirects_followed += 1
                continue
            return status[:1] == CLIENT_OK
        raise ConnectionError(
            f"group {group_id} unreachable after {self.attempts} attempts"
        ) from last_err

    def close(self) -> None:
        for addr in list(self._conns):
            self._drop(addr)
