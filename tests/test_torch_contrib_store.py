"""The port's KV stores against the JAX package's (``tests/test_contrib_store.py``
mirrored case for case): set/get, mset/mget, routing, cluster counts and
clear on the in-memory and TCP backends, the Python and native C++ servers
(the C++ cases skip where there is no compiler, as the JAX package's do),
and the redis gate.  The wire protocol and the shard routing are the JAX
package's: a port client drives a JAX server and a JAX client a port one,
and both packages' cluster views route every key to the same shard."""

import threading

import pytest

from bagua_tpu.contrib.utils import store as jstore
from bagua_tpu.contrib.utils import tcp_store as jtcp
from bagua_tpu_torch.contrib.utils.native_build import BUILD_DIR, ensure_store_server
from bagua_tpu_torch.contrib.utils.store import ClusterStore, InMemoryStore
from bagua_tpu_torch.contrib.utils.tcp_store import (
    TCPClusterStore,
    TCPStore,
    TCPStoreServer,
    start_tcp_store,
)


def _exercise_store(store):
    store.set("a", b"1")
    store.set("b", "2")
    assert store.get("a") == b"1"
    assert store.get("missing") is None
    store.mset({"c": b"3", "d": b"4", "e": b"5"})
    assert store.mget(["a", "c", "nope", "e"]) == [b"1", b"3", None, b"5"]
    assert store.num_keys() == 5
    store.clear()
    assert store.num_keys() == 0
    assert store.status()


def test_in_memory_store():
    _exercise_store(InMemoryStore())


def test_cluster_store_sharded():
    shards = [InMemoryStore() for _ in range(4)]
    cluster = ClusterStore(shards)
    _exercise_store(cluster)
    cluster.mset({f"key{i}": str(i).encode() for i in range(64)})
    assert sum(1 for s in shards if s.num_keys() > 0) >= 2
    assert cluster.num_keys() == 64
    other_view = ClusterStore(shards)
    assert other_view.get("key7") == b"7"
    assert other_view.mget([f"key{i}" for i in range(64)]) == [
        str(i).encode() for i in range(64)
    ]


def test_cluster_routing_matches_jax():
    """The same key goes to the same shard in both packages, so a cache
    written through one package's view is found through the other's."""
    ours = ClusterStore([InMemoryStore() for _ in range(5)])
    theirs = jstore.ClusterStore([jstore.InMemoryStore() for _ in range(5)])
    keys = [f"imagenet_{i}" for i in range(200)]
    assert [ours._hash_key(k) for k in keys] == [theirs._hash_key(k) for k in keys]


def test_tcp_store_roundtrip():
    server = TCPStoreServer()
    try:
        host, port = server.address
        _exercise_store(TCPStore(host, port))
        c1, c2 = TCPStore(host, port), TCPStore(host, port)
        c1.set("shared", b"x")
        assert c2.get("shared") == b"x"
    finally:
        server.stop()


def test_tcp_store_concurrent_writers():
    server = TCPStoreServer()
    try:
        host, port = server.address

        def writer(tid):
            c = TCPStore(host, port)
            for i in range(50):
                c.set(f"t{tid}_{i}", bytes([tid]))

        threads = [threading.Thread(target=writer, args=(t,)) for t in range(4)]
        [t.start() for t in threads]
        [t.join() for t in threads]
        assert TCPStore(host, port).num_keys() == 200
    finally:
        server.stop()


def test_tcp_cluster_store_spawn_and_shutdown():
    cluster = TCPClusterStore(num_shards=3)
    _exercise_store(cluster)
    cluster.mset({f"k{i}": b"v" for i in range(32)})
    assert cluster.num_keys() == 32
    cluster.shutdown()
    assert not cluster.status()


@pytest.mark.parametrize("direction", ["port_client_jax_server", "jax_client_port_server"])
def test_wire_protocol_matches_jax(direction):
    """Either package's client speaks to the other's Python server."""
    if direction == "port_client_jax_server":
        server, client_cls = jtcp.TCPStoreServer(backend="python"), TCPStore
    else:
        server, client_cls = start_tcp_store(backend="python"), jtcp.TCPStore
    try:
        _exercise_store(client_cls(*server.address))
    finally:
        server.stop()


def test_redis_store_is_gated():
    """Without the ``redis`` package the backend raises a clear ImportError
    naming the dependency-free alternative (the JAX package's gate)."""
    try:
        import redis  # noqa: F401
    except ImportError:
        from bagua_tpu_torch.contrib.utils.redis_store import RedisStore

        with pytest.raises(ImportError, match="TCPClusterStore"):
            RedisStore()
    else:
        from bagua_tpu_torch.contrib import CacheLoader

        with pytest.raises(ValueError, match="invalid backend"):
            CacheLoader(backend="nope")


@pytest.mark.parametrize("backend", ["python", "cpp"])
def test_tcp_store_both_backends(backend):
    """Python and native C++ servers speak the same wire protocol."""
    if backend == "cpp" and ensure_store_server() is None:
        pytest.skip("no C++ toolchain")
    server = TCPStoreServer(backend=backend)
    try:
        assert server.is_native == (backend == "cpp")
        _exercise_store(TCPStore(*server.address))
        c = TCPStore(*server.address)
        big = bytes(range(256)) * 4096  # 1 MiB
        c.set("big", big)
        assert c.get("big") == big
    finally:
        server.stop()


def test_native_server_shutdown_op():
    binary = ensure_store_server()
    if binary is None:
        pytest.skip("no C++ toolchain")
    # the binary lands under the repository's ignored build/ directory
    assert binary.startswith(str(BUILD_DIR))
    server = TCPStoreServer(backend="cpp")
    c = TCPStore(*server.address)
    c.set("k", b"v")
    c.shutdown()  # server process exits
    server._proc.wait(timeout=10)
    assert server._proc.returncode == 0
    server._proc = None  # already exited; stop() must not re-wait
