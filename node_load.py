"""Four threaded Nodes of either package at c2's load, on the CPU.

    python3 node_load.py PACKAGE [--proposers 16] [--batch 1] [--buffer 10000] [--tick 0.02]

PACKAGE is ``mirbft_tpu`` (the JAX package; run it with
``JAX_PLATFORMS=cpu``) or ``mirbft_tpu_torch``.  The cluster is the one
``tests/test_node_runtime.py`` builds (durable WALs and request stores,
one delivery thread a node, queues of ``--buffer`` messages that drop on
overflow, 0 for unbounded; a tick of ``--tick`` seconds) with both packages' host hasher
(``CpuHasher``) and Ed25519 verifier on the host, loaded with c2's 800 signed
requests (16 clients x 50) from ``--proposers`` threads.  The run ends
when three nodes hold every request and the fourth holds them too or
has state-transferred, when a node fails, or after ``--timeout`` seconds.
It prints one line: the wall, the first node error (the state machine's
"must never commit during state transfer" assertion is one), requests
committed a node and each node's state-transfer targets.  The runtime
code is the same in both packages (``node.py`` and ``statemachine/`` are
verbatim copies), so the two should fail alike.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib
import os
import queue
import shutil
import tempfile
import threading
import time

NODES, CLIENTS, REQS, TICK = 4, 16, 50, 0.02


class Transport:
    """One bounded queue and one delivery thread a node; a full queue
    drops (tests/test_node_runtime.py's FakeTransport)."""

    def __init__(self, buffer):
        self.queues = [queue.Queue(maxsize=buffer) for _ in range(NODES)]
        self.stopping = threading.Event()
        self.threads = []
        self.nodes = []

    def link(self, source):
        transport = self

        class _Link:
            def send(self, dest, msg):
                try:
                    transport.queues[dest].put_nowait((source, msg))
                except queue.Full:
                    pass

        return _Link()

    def start(self, nodes):
        self.nodes = nodes
        for dest in range(NODES):
            thread = threading.Thread(target=self._deliver, args=(dest,), daemon=True)
            thread.start()
            self.threads.append(thread)

    def _deliver(self, dest):
        while not self.stopping.is_set():
            try:
                source, msg = self.queues[dest].get(timeout=0.05)
            except queue.Empty:
                continue
            try:
                self.nodes[dest].step(source, msg)
            except Exception:
                return  # the node stopped

    def stop(self):
        self.stopping.set()
        for thread in self.threads:
            thread.join(timeout=2)


def make_app(pkg):
    wire, messages = pkg("wire"), pkg("messages")

    class App:
        """Counts commits per (client, req_no); records state transfers."""

        def __init__(self):
            self.commits, self.transfers, self.lock = {}, [], threading.Lock()

        def apply(self, entry):
            with self.lock:
                for req in entry.requests:
                    key = (req.client_id, req.req_no)
                    self.commits[key] = self.commits.get(key, 0) + 1

        def snap(self, network_config, client_states):
            encoded = wire.encode(messages.NetworkState(
                config=network_config, clients=tuple(client_states),
                pending_reconfigurations=()))
            return hashlib.sha256(encoded).digest() + encoded, ()

        def transfer_to(self, seq_no, snap):
            with self.lock:
                self.transfers.append(seq_no)
            return wire.decode(snap[32:])

    return App


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("package", choices=("mirbft_tpu", "mirbft_tpu_torch"))
    parser.add_argument("--proposers", type=int, default=CLIENTS)
    parser.add_argument("--batch", type=int, default=1)
    parser.add_argument("--buffer", type=int, default=10000)
    parser.add_argument("--tick", type=float, default=TICK)
    parser.add_argument("--timeout", type=float, default=180.0)
    args = parser.parse_args()
    pkg = lambda name: importlib.import_module(f"{args.package}.{name}")
    config, node_mod, verify, ed25519 = pkg("config"), pkg("node"), pkg("processor.verify"), \
        pkg("ops.ed25519")
    store_mod, wal_mod, ops = pkg("reqstore"), pkg("simplewal"), pkg("ops")

    keys, envelopes = {}, {}
    for c in range(CLIENTS):
        pub, sign = ed25519.keypair_from_seed(hashlib.sha256(b"embedded-client-%d" % c).digest())
        keys[c] = pub
        for r in range(REQS):
            payload = b"embedded-req-%d-%d" % (c, r)
            envelopes[c, r] = verify.seal(payload, sign(verify.signing_payload(c, r, payload)))

    tmp = tempfile.mkdtemp(prefix="node-load-")
    network_state = config.standard_initial_network_state(NODES, *range(CLIENTS))
    transport, nodes, apps = Transport(args.buffer), [], []
    app_cls = make_app(pkg)
    # Both verifiers check single envelopes on the host (below
    # min_device_batch); the port's is told to keep its waves on the CPU.
    on_cpu = {"device": "cpu"} if args.package == "mirbft_tpu_torch" else {}
    for i in range(NODES):
        auth = verify.RequestAuthenticator(verifier=ed25519.Ed25519BatchVerifier(**on_cpu))
        for c, pub in keys.items():
            auth.register(c, pub)
        apps.append(app_cls())
        nodes.append(node_mod.Node(i, config.Config(id=i, batch_size=args.batch),
                                   node_mod.ProcessorConfig(
            link=transport.link(i), hasher=ops.CpuHasher(), app=apps[-1],
            wal=wal_mod.WAL(os.path.join(tmp, f"wal-{i}")),
            request_store=store_mod.Store(os.path.join(tmp, f"reqs-{i}.db")),
            authenticator=auth)))
    transport.start(nodes)
    for node in nodes:
        node.process_as_new_node(network_state, b"initial", tick_interval=args.tick)

    def propose(clients):
        for r in range(REQS):
            for c in clients:
                for node in nodes:
                    for _ in range(3000):
                        try:
                            node.client(c).propose(r, envelopes[c, r])
                            break
                        except KeyError:
                            time.sleep(0.01)  # the client window is not allocated

    threads = [threading.Thread(target=propose, args=(list(range(CLIENTS))[k::args.proposers],),
                                daemon=True) for k in range(args.proposers)]
    start = time.time()
    for thread in threads:
        thread.start()
    want, error = set(envelopes), None
    while time.time() - start < args.timeout:
        errors = [(n.id, n.notifier.err()) for n in nodes if n.notifier.err() is not None]
        if errors:
            error = errors[0]
            break
        full = [want <= set(app.commits) for app in apps]
        if sum(full) >= 3 and all(f or app.transfers for f, app in zip(full, apps)):
            break
        time.sleep(0.1)
    wall = time.time() - start
    for node in nodes:
        node.stop()
    transport.stop()
    twice = sum(n > 1 for app in apps for n in app.commits.values())
    print(f"package={args.package} proposers={args.proposers} batch={args.batch} "
          f"buffer={args.buffer} tick={args.tick} wall_s={wall:.1f} error={error!r} "
          f"committed_a_node={[len(app.commits) for app in apps]} committed_twice={twice} "
          f"transfers={[app.transfers for app in apps]}", flush=True)
    shutil.rmtree(tmp, ignore_errors=True)
    os._exit(0)  # the nodes' daemon threads


if __name__ == "__main__":
    raise SystemExit(main())
