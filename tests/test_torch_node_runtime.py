"""The port's threaded node runtime on the CPU twins of its kernels.

``tests/test_node_runtime.py``'s stress cluster on the port: real threads,
the durable WAL and request store on temporary directories, a channel
transport that drops on overflow.  Each node hashes through ``TorchHasher``
and verifies signed requests through ``Ed25519BatchVerifier``, both with
``device="cpu"`` (the plain PyTorch twins the CUDA kernels are held to).
Every request must commit exactly once on every node, and every committed
request and batch digest must equal the JAX package's ``CpuHasher`` (hashlib)
on the same bytes.
"""

import hashlib
import queue
import threading
import time

import pytest
import torch

from mirbft_tpu.ops import CpuHasher as RefCpuHasher
from mirbft_tpu_torch import metrics, tracing
from mirbft_tpu_torch.config import Config, standard_initial_network_state
from mirbft_tpu_torch.node import AuthenticationError, Node, ProcessorConfig
from mirbft_tpu_torch.ops.ed25519 import Ed25519BatchVerifier, keypair_from_seed
from mirbft_tpu_torch.ops.sha256 import TorchHasher
from mirbft_tpu_torch.processor.verify import RequestAuthenticator, seal, signing_payload
from mirbft_tpu_torch.reqstore import Store
from mirbft_tpu_torch.simplewal import WAL

DEVICE = "cpu"
# The plain twins hash a 1 KB message in ~0.2 s where hashlib takes
# microseconds, and the protocol counts its timeouts in ticks: at the JAX
# package's 0.02 s tick, four nodes hashing on the twins at once miss their
# heartbeats, suspect each other and hash epoch changes on top.  A 0.5 s
# tick keeps the timeouts above the twins' hashing time.
TICK = 0.5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    # Four nodes' hash workers run the twins at once: one intra-op thread
    # each keeps them from oversubscribing the cores.
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _reset_port_observability():
    metrics.default_registry.reset()
    tracing.default_tracer.clear()
    tracing.default_tracer.enabled = False
    yield


class SerialTwinHasher:
    """``TorchHasher`` on the CPU twins, one hash call at a time across the
    process.  The four nodes share this process, and their twins run at
    once slow each other down until two nodes fall behind and
    state-transfer (a 4-node run took 49 s so; serialized, 10.5 s on an
    8-core host).  On the card the nodes' waves share one stream anyway."""

    _lock = threading.Lock()

    def __init__(self):
        self.hasher = TorchHasher(min_device_batch=1, device=DEVICE)

    def hash_batches(self, batches):
        with self._lock:
            return self.hasher.hash_batches(batches)


class FakeTransport:
    """Buffered per-node delivery queues that drop on overflow."""

    def __init__(self, node_count: int, buffer: int = 10000):
        self.queues = [queue.Queue(maxsize=buffer) for _ in range(node_count)]
        self.nodes = [None] * node_count
        self._threads = []
        self._stop = threading.Event()

    def link(self, source: int):
        transport = self

        class _Link:
            def send(self, dest: int, msg) -> None:
                try:
                    transport.queues[dest].put_nowait((source, msg))
                except queue.Full:
                    pass  # drop; consensus tolerates loss

        return _Link()

    def start(self, nodes):
        self.nodes = nodes
        for i in range(len(nodes)):
            thread = threading.Thread(target=self._deliver, args=(i,), daemon=True)
            thread.start()
            self._threads.append(thread)

    def _deliver(self, dest: int) -> None:
        while not self._stop.is_set():
            try:
                source, msg = self.queues[dest].get(timeout=0.05)
            except queue.Empty:
                continue
            try:
                self.nodes[dest].step(source, msg)
            except Exception:
                return  # node stopped

    def stop(self):
        self._stop.set()
        for thread in self._threads:
            thread.join(timeout=2)


class CommitLog:
    """Counts commits per (client, req_no) and keeps every applied entry."""

    def __init__(self):
        self.commits = {}
        self.entries = []
        self.lock = threading.Lock()
        self.state_transfers = []

    def apply(self, entry) -> None:
        with self.lock:
            self.entries.append(entry)
            for req in entry.requests:
                key = (req.client_id, req.req_no)
                self.commits[key] = self.commits.get(key, 0) + 1

    def snap(self, network_config, client_states):
        from mirbft_tpu_torch import wire
        from mirbft_tpu_torch.messages import NetworkState

        state = NetworkState(
            config=network_config, clients=tuple(client_states), pending_reconfigurations=()
        )
        encoded = wire.encode(state)
        return hashlib.sha256(encoded).digest() + encoded, ()

    def transfer_to(self, seq_no, snap):
        from mirbft_tpu_torch import wire

        with self.lock:
            self.state_transfers.append(seq_no)
        return wire.decode(snap[32:])


def _check_digests(log, data_of):
    """Each committed request's digest and each batch digest equal the JAX
    package's CpuHasher on the request bytes (``data_of[(client, req)]``)
    and on the request digests, in order."""
    ref = RefCpuHasher()
    assert log.entries
    for entry in log.entries:
        if not entry.requests:
            assert entry.digest == b""  # a null batch carries no digest
            continue
        for req in entry.requests:
            (want,) = ref.hash_batches([[data_of[(req.client_id, req.req_no)]]])
            assert req.digest == want
        (want,) = ref.hash_batches([[req.digest for req in entry.requests]])
        assert entry.digest == want, entry.seq_no


def _wait(condition, what, nodes, timeout=120):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if condition():
            return
        for node in nodes:
            err = node.notifier.err()
            if err is not None:
                pytest.fail(f"node {node.id} failed: {err!r}")
        time.sleep(0.05)
    pytest.fail(f"timed out waiting for {what}")


def _propose(node, req_no, envelope):
    # Retry until the client window is allocated on this node: forwarding
    # is pull-only, so a proposer that gives up loses the body.
    for _ in range(600):
        try:
            node.client(0).propose(req_no, envelope)
            return
        except KeyError:
            time.sleep(0.02)
    pytest.fail("client window never allocated")


def test_stressy_device_crypto(tmp_path):
    """Four threaded nodes, each hashing through TorchHasher and gating
    signed requests on Ed25519BatchVerifier's verdicts (the twins): all ten
    requests commit exactly once a node with hashlib's digests, the forgery
    is rejected at propose from the verify wave's verdict, and both crypto
    paths are metered."""
    node_count, reqs = 4, 10
    pub, sign = keypair_from_seed(hashlib.sha256(b"stressy-device-client-0").digest())
    envelopes = []
    for req_no in range(reqs):
        payload = b"device-req-%d" % req_no
        envelopes.append(seal(payload, sign(signing_payload(0, req_no, payload))))
    forged = seal(b"forged", b"\x22" * 64)

    network_state = standard_initial_network_state(node_count, 0)
    transport = FakeTransport(node_count)
    nodes, logs, authenticators = [], [], []
    for i in range(node_count):
        auth = RequestAuthenticator(
            verifier=Ed25519BatchVerifier(min_device_batch=1, device=DEVICE)
        )
        auth.register(0, pub)
        # The whole ingress window in one verify wave; the propose gate
        # serves from the memoized verdicts.
        verdicts = auth.authenticate_batch(
            [(0, r, envelopes[r]) for r in range(reqs)] + [(0, reqs, forged)], memoize=True
        )
        assert verdicts[:reqs].all() and not verdicts[reqs]
        authenticators.append(auth)
        log = CommitLog()
        logs.append(log)
        nodes.append(Node(
            i,
            Config(id=i, batch_size=1),
            ProcessorConfig(
                link=transport.link(i),
                hasher=SerialTwinHasher(),
                app=log,
                wal=WAL(str(tmp_path / f"wal-{i}")),
                request_store=Store(str(tmp_path / f"reqs-{i}.db")),
                authenticator=auth,
            ),
        ))
    transport.start(nodes)
    for node in nodes:
        node.process_as_new_node(network_state, b"initial", tick_interval=TICK)

    def propose_all():
        for req_no in range(reqs):
            for node in nodes:
                _propose(node, req_no, envelopes[req_no])

    proposer = threading.Thread(target=propose_all, daemon=True)
    proposer.start()
    try:
        _wait(
            lambda: all(
                log.state_transfers or all(log.commits.get((0, r)) for r in range(reqs))
                for log in logs
            ) and any(not log.state_transfers for log in logs),
            "every request on every node", nodes,
        )
        assert sum(1 for log in logs if log.state_transfers) <= (node_count - 1) // 3
        data_of = {(0, r): envelopes[r] for r in range(reqs)}
        for log in logs:
            if log.state_transfers:
                continue
            assert all(log.commits.get((0, r)) == 1 for r in range(reqs)), log.commits
            _check_digests(log, data_of)
        with pytest.raises(AuthenticationError):
            nodes[0].client(0).propose(reqs, forged)
        snap = metrics.snapshot()
        assert snap.get("hash_dispatch_seconds_count", 0) > 0, snap
        for auth in authenticators:
            assert auth.verified_count >= reqs + 1
            assert auth.dispatch_seconds
        assert nodes[0].health()["peer_faults"].get("0:ingress_reject") == 1
    finally:
        proposer.join(timeout=5)
        for node in nodes:
            node.stop()
        transport.stop()


def test_node_restart_from_durable_wal(tmp_path):
    """One node hashing on TorchHasher commits, stops, restarts from its
    on-disk WAL and request store, and keeps committing; the batches of
    both lives carry hashlib's digests."""
    network_state = standard_initial_network_state(1, 0)
    transport = FakeTransport(1)

    def make_node():
        log = CommitLog()
        node = Node(
            0,
            Config(id=0, batch_size=1),
            ProcessorConfig(
                link=transport.link(0),
                hasher=TorchHasher(min_device_batch=1, device=DEVICE),
                app=log,
                wal=WAL(str(tmp_path / "wal")),
                request_store=Store(str(tmp_path / "reqs.db")),
            ),
        )
        return node, log

    node, log = make_node()
    transport.start([node])
    node.process_as_new_node(network_state, b"initial", tick_interval=TICK)
    data_of = {(0, r): b"pre-%d" % r for r in range(5)}
    data_of.update({(0, r): b"post-%d" % r for r in range(5, 10)})
    for req_no in range(5):
        _propose(node, req_no, data_of[(0, req_no)])
    _wait(lambda: all(log.commits.get((0, r)) for r in range(5)), "first life", [node])
    node.stop()
    node.processor_config.wal.close()
    node.processor_config.request_store.close()
    _check_digests(log, data_of)

    node2, log2 = make_node()
    transport.nodes = [node2]
    node2.restart_processing(tick_interval=TICK)
    try:
        for req_no in range(5, 10):
            _propose(node2, req_no, data_of[(0, req_no)])
        _wait(lambda: all(log2.commits.get((0, r)) for r in range(5, 10)), "second life",
              [node2])
        _check_digests(log2, data_of)
        assert all(log.commits.get((0, r), 0) == 0 for r in range(5, 10))
    finally:
        node2.stop()
        transport.stop()
