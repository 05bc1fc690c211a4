"""Runtime configuration and canonical network-state construction.

Rebuild of reference ``config.go`` and ``mirbft.go:104-133``
(``StandardInitialNetworkState``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from .logger import Logger
from .messages import ClientState, NetworkConfig, NetworkState
from .state import EventInitialParameters

DEFAULT_CLIENT_WIDTH = 100


@dataclass
class Config:
    """Runtime (non-consensused) knobs (reference config.go:9-36)."""

    id: int
    batch_size: int = 20
    heartbeat_ticks: int = 2
    suspect_ticks: int = 4
    new_epoch_timeout_ticks: int = 8
    buffer_size: int = 5 * 1024 * 1024
    # Leveled kv logger (``mirbft_tpu_torch.logger``; reference logger.go:62-67).
    logger: Optional[Logger] = None

    def initial_parameters(self) -> EventInitialParameters:
        """Reference mirbft.go:425-434."""
        return EventInitialParameters(
            id=self.id,
            batch_size=self.batch_size,
            heartbeat_ticks=self.heartbeat_ticks,
            suspect_ticks=self.suspect_ticks,
            new_epoch_timeout_ticks=self.new_epoch_timeout_ticks,
            buffer_size=self.buffer_size,
        )


def standard_initial_network_state(
    node_count: int, *client_ids: int, client_width: int = DEFAULT_CLIENT_WIDTH
) -> NetworkState:
    """Canonical config generator (reference mirbft.go:104-133): N nodes,
    buckets = N, checkpoint interval = 5·buckets, max epoch length = 10·ci,
    f = (n−1)//3."""
    number_of_buckets = node_count
    checkpoint_interval = number_of_buckets * 5
    max_epoch_length = checkpoint_interval * 10
    return NetworkState(
        config=NetworkConfig(
            nodes=tuple(range(node_count)),
            f=(node_count - 1) // 3,
            number_of_buckets=number_of_buckets,
            checkpoint_interval=checkpoint_interval,
            max_epoch_length=max_epoch_length,
        ),
        clients=tuple(
            ClientState(
                id=client_id,
                width=client_width,
                width_consumed_last_checkpoint=0,
                low_watermark=0,
                committed_mask=b"",
            )
            for client_id in client_ids
        ),
        pending_reconfigurations=(),
    )
