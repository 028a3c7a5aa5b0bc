"""Cross-trainer record exchange for InMemoryDataset.global_shuffle (the
port's copy of ``paddle_tpu.dataset.shuffle_service``, stdlib only).

Reference analog: data_set.cc GlobalShuffle → fleet SendClientToClientMsg
(the gRPC trainer-to-trainer channel). The port has no pserver RPC
fabric for records, so this is a self-contained TCP all-to-all: every trainer runs a
tiny accept loop and pushes each peer its bucket; the exchange is a single
barrier-free N×N transfer of pickled record lists.

Addressing derives from the launcher's PADDLE_TRAINER_ENDPOINTS list
(distributed/launch.py): trainer r listens on its endpoint's host at
`port + _PORT_OFFSET + r` (override the offset with
PADDLE_SHUFFLE_PORT_OFFSET when the range collides).
"""
from __future__ import annotations

import os
import pickle
import socket
import struct
import threading
import time
from typing import List

_PORT_OFFSET = 317


def _endpoints() -> List[str]:
    eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
    return [e for e in eps.split(",") if e]


def _shuffle_addr(rank: int):
    eps = _endpoints()
    host, port = eps[rank].rsplit(":", 1)
    off = int(os.environ.get("PADDLE_SHUFFLE_PORT_OFFSET", _PORT_OFFSET))
    return host, int(port) + off + rank


def _send_msg(sock: socket.socket, rank: int, payload: bytes):
    sock.sendall(struct.pack("<iq", rank, len(payload)))
    sock.sendall(payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    while n:
        b = sock.recv(min(n, 1 << 20))
        if not b:
            raise ConnectionError("shuffle peer closed mid-message")
        chunks.append(b)
        n -= len(b)
    return b"".join(chunks)


def exchange_records(buckets, rank: int, nranks: int,
                     timeout: float = 120.0):
    """All-to-all: send buckets[d] to trainer d; return own bucket + the
    records every peer routed here. Collective — all ranks must call."""
    eps = _endpoints()
    if len(eps) < nranks:
        raise RuntimeError(
            f"global_shuffle: PADDLE_TRAINER_ENDPOINTS has {len(eps)} "
            f"entries but {nranks} trainers are active — launch through "
            f"paddle_tpu_torch.distributed.launch (or set the env) so trainers "
            f"can route records to each other")

    received = [None] * nranks
    received[rank] = buckets[rank]
    errors: List[BaseException] = []

    host, port = _shuffle_addr(rank)
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind((host, port))
    srv.listen(nranks)
    srv.settimeout(timeout)

    def serve():
        # Trust model (matches the reference's fleet RPC): the endpoint
        # list is cluster-internal; payloads are pickled, so the port range
        # must not be reachable by untrusted hosts. Headers are still
        # validated so a stray/misconfigured peer fails loudly instead of
        # corrupting this rank's buckets.
        try:
            for _ in range(nranks - 1):
                conn, _addr = srv.accept()
                with conn:
                    hdr = _recv_exact(conn, 12)
                    src, ln = struct.unpack("<iq", hdr)
                    if not (0 <= src < nranks) or src == rank:
                        raise RuntimeError(
                            f"global_shuffle: bad peer header src={src} "
                            f"(rank={rank}, nranks={nranks})")
                    if not (0 <= ln <= (1 << 34)):  # 16 GiB sanity bound
                        raise RuntimeError(
                            f"global_shuffle: bad peer header len={ln} "
                            f"from trainer {src}")
                    if received[src] is not None:
                        raise RuntimeError(
                            f"global_shuffle: duplicate payload from "
                            f"trainer {src}")
                    received[src] = pickle.loads(_recv_exact(conn, ln))
        except BaseException as e:  # surfaced after join
            errors.append(e)

    t = threading.Thread(target=serve, daemon=True)
    t.start()

    payloads = {d: pickle.dumps(buckets[d], protocol=4)
                for d in range(nranks) if d != rank}
    deadline = time.time() + timeout
    for d in range(nranks):
        if d == rank:
            continue
        dh, dp = _shuffle_addr(d)
        last = None
        while True:
            try:
                with socket.create_connection((dh, dp), timeout=5.0) as s:
                    _send_msg(s, rank, payloads[d])
                break
            except OSError as e:  # peer's server not up yet
                last = e
                if time.time() > deadline:
                    raise TimeoutError(
                        f"global_shuffle: cannot reach trainer {d} at "
                        f"{dh}:{dp} within {timeout}s") from last
                time.sleep(0.1)

    t.join(timeout)
    srv.close()
    if errors:
        raise RuntimeError("global_shuffle exchange failed") from errors[0]
    if t.is_alive() or any(r is None for r in received):
        missing = [i for i, r in enumerate(received) if r is None]
        raise TimeoutError(
            f"global_shuffle: no records received from trainers {missing} "
            f"within {timeout}s")
    out = []
    for r in received:
        out.extend(r)
    return out
