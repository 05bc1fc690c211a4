"""Multi-group sharded consensus plane (docs/SHARDING.md).

Each group is a full, independent mirbft instance — its own
StageGraph-scheduled node runtime, its own storage directory — and this
package supplies everything *above* the protocol core:

* :mod:`~mirbft_tpu_torch.groups.routing` — ``hash(client_id) -> group``,
  the :class:`GroupMap`, and the route-aware :class:`RoutedClient`
  (group-enveloped KIND_CLIENT frames, redirect-following).
* :mod:`~mirbft_tpu_torch.groups.ship` — the KIND_GROUP subframe codec and
  the host-side :class:`ShipFeed` (committed-batch log shipping).
* :mod:`~mirbft_tpu_torch.groups.observer` — the non-voting
  :class:`Observer`/learner role: snapshot bootstrap over KIND_SNAPSHOT,
  then log tailing to a bit-identical checkpoint state.
* :mod:`~mirbft_tpu_torch.groups.cohost` — the shared crypto plane for the
  cohost layout: one :class:`CohostCryptoPlane` multiplexes every
  co-hosted group's hash/verify work into shared group-tagged fused
  device waves (``testengine.crypto.SharedWaveMux``).

Deployment wiring (topology files, child processes, scenarios) lives in
``tools/mirnet.py``; this package has no process-management concerns.
"""

from .cohost import CohostCryptoPlane
from .observer import Observer
from .routing import (
    CLIENT_BUSY,
    CLIENT_OK,
    CLIENT_REDIRECT,
    CLIENT_REQ,
    GroupMap,
    RoutedClient,
    client_for_group,
    group_for_client,
)
from .ship import ShipFeed

__all__ = [
    "CLIENT_BUSY",
    "CLIENT_OK",
    "CLIENT_REDIRECT",
    "CLIENT_REQ",
    "CohostCryptoPlane",
    "GroupMap",
    "Observer",
    "RoutedClient",
    "ShipFeed",
    "client_for_group",
    "group_for_client",
]
