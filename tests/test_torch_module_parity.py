"""Module-level parity of the port with the JAX package.

For every module of ``bagua_tpu/`` that has a counterpart in
``bagua_tpu_torch/`` (the same relative path), each public name the JAX
module defines at module level (a function, a class, an assignment) must be
bound in the port's module (defined or imported), unless ``NOT_PORTED``
lists it with a reason.  Names are read with ``ast``: nothing is imported.
``tests/test_torch_api.py`` holds the package's top-level names; this file
holds every module's.

The helpers that were ported for this check are held against their JAX
functions on the same inputs, exactly (they are arithmetic-free or integer
maps).
"""

import ast
import os

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG, PORT_PKG = os.path.join(REPO, "bagua_tpu"), os.path.join(REPO, "bagua_tpu_torch")

#: (module path under the package, name) -> why the port has no such name.
#: "Queue 3" points at ROADMAP.md's entry of that title.
NOT_PORTED = {
    ("profiling.py", "parse_xplane_comm_events"):
        "XLA xplane protos; the port's profiles are torch.profiler Chrome traces "
        "(Queue 3, 'The observability plane')",
    ("profiling.py", "parse_xplane_memory_traffic"):
        "XLA xplane protos (Queue 3, 'The observability plane')",
    ("profiling.py", "parse_xplane_op_profile"):
        "XLA xplane protos (Queue 3, 'The observability plane')",
    ("profiling.py", "parse_xplane_overlap"):
        "XLA xplane protos (Queue 3, 'The observability plane')",
    ("obs/memory.py", "compiled_memory_analysis"):
        "reads a compiled XLA executable; eager torch compiles none "
        "(Queue 3, 'The observability plane')",
    ("serve/engine.py", "clear_serve_program_cache"):
        "JAX's cache of jitted tick programs; the port jits nothing (Queue 3, 'Serving')",
    ("models/generate.py", "clear_generate_cache"):
        "JAX's _GEN_CACHE of compiled decode programs (Queue 3, 'Decoding')",
    ("models/generate.py", "clear_tp_generate_cache"):
        "JAX's _TP_GEN_CACHE of compiled decode programs (Queue 3, 'Decoding')",
    ("utils.py", "lru_get_or_build"):
        "the LRU idiom of the JAX program caches above, which the port does not keep",
    ("utils.py", "logger"):
        "a module logger no port code writes to; each port module logs through its own",
    ("telemetry.py", "logger"):
        "a module logger no port code writes to; each port module logs through its own",
    ("utils.py", "device_fence"):
        "a readback fence for tunneled TPU transports; torch.cuda.synchronize fences the card",
    ("ops/flash_attention.py", "MIN_FLASH_SEQ"):
        "the TPU flash gate's sequence floor (Queue 3, 'The flash_supported gate')",
    ("ops/flash_attention.py", "flash_supported"):
        "the TPU flash gate (Queue 3, 'The flash_supported gate')",
    ("env.py", "is_flash_attention_enabled"):
        "BAGUA_FLASH_ATTENTION drives the TPU flash gate (Queue 3, 'The flash_supported gate')",
    ("env.py", "is_pallas_codec_disabled"):
        "BAGUA_DISABLE_PALLAS_CODEC picks JAX's Pallas codec; the port's codec is codec.cu",
    ("env.py", "get_max_exchange_period"):
        "caps the gossip peer schedule unrolled into a traced program; the port picks the "
        "peer eagerly each step (Queue 3, 'Gossip exchanges')",
    ("env.py", "sanitize_cpu_sim_env"):
        "strips PJRT accelerator plugins from a virtual-CPU-mesh child; the port has no "
        "virtual devices",
    ("env.py", "ACCELERATOR_PLUGIN_ENV_VARS"):
        "the PJRT plugin triggers sanitize_cpu_sim_env strips",
    ("parallel/mesh.py", "axis_bound"):
        "whether a named axis is bound in a shard_map trace; a port rank is always in its mesh "
        "(Queue 3, 'Process groups for a mesh')",
    ("parallel/mesh.py", "make_global_array"):
        "builds a sharded jax.Array; a port rank holds its own tensors "
        "(Queue 3, 'Process groups for a mesh')",
    ("tensor.py", "leaves_by_name"):
        "names the leaves of a JAX pytree; the port names parameters with "
        "nn.Module.named_parameters (tensor.build_params)",
    ("tensor.py", "tree_from_named"):
        "rebuilds a JAX pytree from names; a module's load_state_dict does that in torch",
    ("contrib/fused_optimizer.py", "FusedTransformation"):
        "an optax GradientTransformation; the port's fuse_optimizer wraps an optimizer "
        "factory (Queue 3, 'Grouped optimizers')",
    ("models/resnet.py", "ModuleDef"):
        "flax's type alias for a module constructor",
    ("analysis/ast_rules.py", "HostSyncInTrace"):
        "a JAX rule; the port's counterpart is host-sync-in-step "
        "(Queue 3, 'bagua-lint's rule catalog')",
    ("analysis/ast_rules.py", "PyRngInTrace"):
        "a JAX rule; the port's counterpart is py-rng-in-step "
        "(Queue 3, 'bagua-lint's rule catalog')",
    ("analysis/ast_rules.py", "TorchImport"):
        "a JAX rule; the port's counterpart is jax-import "
        "(Queue 3, 'bagua-lint's rule catalog')",
    ("analysis/ast_rules.py", "TracerLeak"):
        "eager torch has no tracers: tracer-leak has no counterpart "
        "(Queue 3, 'bagua-lint's rule catalog')",
}


def _tree(path):
    with open(path) as f:
        return ast.parse(f.read(), filename=path)


def _defined(tree):
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for target in targets:
                out.update(n.id for n in ast.walk(target) if isinstance(n, ast.Name))
    return out


def _bound(tree):
    out = _defined(tree)
    for node in ast.walk(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            out.update((a.asname or a.name).split(".")[0] for a in node.names)
    return out


def _module_pairs():
    pairs = []
    for root, _, files in os.walk(JAX_PKG):
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(root, f), JAX_PKG).replace(os.sep, "/")
            if os.path.exists(os.path.join(PORT_PKG, rel)):
                pairs.append(rel)
    return sorted(pairs)


PAIRS = _module_pairs()


def test_every_module_pair_is_checked():
    assert len(PAIRS) > 100
    assert {rel for rel, _ in NOT_PORTED} <= set(PAIRS)


@pytest.mark.parametrize("rel", PAIRS)
def test_module_level_names_exist_in_the_port(rel):
    want = {n for n in _defined(_tree(os.path.join(JAX_PKG, rel))) if not n.startswith("_")}
    have = _bound(_tree(os.path.join(PORT_PKG, rel)))
    missing = sorted(n for n in want - have if (rel, n) not in NOT_PORTED)
    assert not missing, f"{rel}: not in the port and not in NOT_PORTED: {missing}"


def test_not_ported_entries_are_missing_and_reasoned():
    for (rel, name), why in NOT_PORTED.items():
        assert name in _defined(_tree(os.path.join(JAX_PKG, rel))), (rel, name)
        assert name not in _bound(_tree(os.path.join(PORT_PKG, rel))), (
            f"{rel}:{name} is ported now; take it out of NOT_PORTED")
        assert len(why) > 20


# -- the ported helpers against the JAX functions ---------------------------


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (5,), (2, 1, 3), (1,))]


def test_flatten_unflatten_match_jax():
    import jax.numpy as jnp

    from bagua_tpu import utils as ju
    from bagua_tpu_torch import utils as tu

    arrays = _arrays()
    want = np.asarray(ju.flatten([jnp.asarray(a) for a in arrays]))
    got = tu.flatten([torch.from_numpy(a) for a in arrays])
    np.testing.assert_array_equal(got.numpy(), want)
    back_j = ju.unflatten(jnp.asarray(want), [jnp.asarray(a) for a in arrays])
    back_t = tu.unflatten(got, [torch.from_numpy(a) for a in arrays])
    for bj, bt_ in zip(back_j, back_t):
        np.testing.assert_array_equal(bt_.numpy(), np.asarray(bj))
    assert tu.flatten([]).shape == (0,) and ju.flatten([]).shape == (0,)
    assert tu.flatten([]).dtype == torch.float32


def test_check_contiguous_matches_jax():
    from bagua_tpu import utils as ju
    from bagua_tpu_torch import utils as tu

    cases = [([3, 4, 5], [0, 3, 7]), ([3, 4, 5], [0, 3, 8]), ([], []), ([2], [1])]
    for sizes, offsets in cases:
        assert tu.check_contiguous(sizes, offsets) == ju.check_contiguous(sizes, offsets)


def test_apply_flattened_call_matches_jax():
    import jax.numpy as jnp

    from bagua_tpu import utils as ju
    from bagua_tpu_torch import utils as tu

    a = _arrays(1)
    jtree = {"b": [jnp.asarray(a[0]), jnp.asarray(a[1])], "a": {"x": jnp.asarray(a[2])},
             "c": jnp.asarray(a[3])}
    ttree = {"b": [torch.from_numpy(a[0]), torch.from_numpy(a[1])],
             "a": {"x": torch.from_numpy(a[2])}, "c": torch.from_numpy(a[3])}
    ramp = lambda flat, n: flat * 2.0 + (jnp.arange(n) if isinstance(flat, jnp.ndarray)  # noqa: E731
                                         else torch.arange(n, dtype=flat.dtype))
    n = sum(x.size for x in a)
    want = ju.apply_flattened_call(jtree, lambda f: ramp(f, n))
    got = tu.apply_flattened_call(ttree, lambda f: ramp(f, n))
    np.testing.assert_array_equal(got["b"][0].numpy(), np.asarray(want["b"][0]))
    np.testing.assert_array_equal(got["b"][1].numpy(), np.asarray(want["b"][1]))
    np.testing.assert_array_equal(got["a"]["x"].numpy(), np.asarray(want["a"]["x"]))
    np.testing.assert_array_equal(got["c"].numpy(), np.asarray(want["c"]))


def test_bagua_datatype_maps_match_jax():
    import jax.numpy as jnp

    from bagua_tpu import utils as ju
    from bagua_tpu_torch import utils as tu

    pairs = [(jnp.float32, torch.float32), (jnp.float16, torch.float16),
             (jnp.bfloat16, torch.bfloat16), (jnp.uint8, torch.uint8),
             (jnp.int32, torch.int32), (jnp.int64, torch.int64)]
    for jd, td in pairs:
        wire = ju.to_bagua_datatype(jd)
        assert tu.to_bagua_datatype(td) == wire
        assert tu.from_bagua_datatype(wire) == td
        assert tu.from_bagua_datatype(wire.value) == td
        assert np.dtype(ju.from_bagua_datatype(wire)).name == str(td).split(".")[1]
    with pytest.raises(ValueError, match="unsupported"):
        tu.to_bagua_datatype(torch.complex64)


def test_find_free_port_binds():
    import socket

    from bagua_tpu_torch.utils import find_free_port

    port = find_free_port()
    assert 0 < port < 65536
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", port))


@pytest.mark.parametrize("environ,want_node", [
    ({}, 0),
    ({"RANK": "5", "LOCAL_WORLD_SIZE": "2"}, 2),
    ({"RANK": "5", "LOCAL_WORLD_SIZE": "2", "NODE_RANK": "7"}, 7),
    ({"MASTER_ADDR": "10.1.2.3", "RANK": "3"}, 3),
])
def test_node_rank_and_master_addr_match_jax(monkeypatch, environ, want_node):
    from bagua_tpu import env as jenv
    from bagua_tpu_torch import env as tenv

    for var in ("RANK", "LOCAL_WORLD_SIZE", "NODE_RANK", "MASTER_ADDR"):
        monkeypatch.delenv(var, raising=False)
    for k, v in environ.items():
        monkeypatch.setenv(k, v)
    assert tenv.get_node_rank() == jenv.get_node_rank() == want_node
    assert tenv.get_master_addr() == jenv.get_master_addr() == environ.get(
        "MASTER_ADDR", "127.0.0.1")


def test_tensor_declaration_bytes_match_jax():
    from bagua_tpu import define as jdef
    from bagua_tpu_torch import define as tdef

    for dtype, n in (("f32", 10), ("bf16", 7), ("u8", 33), ("i64", 3)):
        j = jdef.TensorDeclaration(name="w", num_elements=n, dtype=dtype)
        t = tdef.TensorDeclaration(name="w", num_elements=n, dtype=dtype)
        assert tdef.get_tensor_declaration_bytes(t) == jdef.get_tensor_declaration_bytes(j)


@pytest.mark.parametrize("shape,axes", [
    ({"inter": 1, "intra": 4}, ("inter", "intra")),
    ({"inter": 2, "intra": 1}, ("inter", "intra")),
    ({"inter": 1, "intra": 1}, ("inter", "intra")),
    ({"dp": 2, "ep": 2}, "ep"),
    ({"dp": 2, "tp": 1, "pp": 2}, ("dp", "tp", "pp")),
])
def test_collapse_trivial_axes_matches_jax(shape, axes):
    import jax
    from jax.sharding import Mesh as JMesh

    from bagua_tpu.communication import collapse_trivial_axes as jcollapse
    from bagua_tpu_torch.communication import collapse_trivial_axes
    from bagua_tpu_torch.parallel.mesh import Mesh

    n = int(np.prod(list(shape.values())))
    jmesh = JMesh(np.array(jax.devices()[:n]).reshape(tuple(shape.values())), tuple(shape))
    assert collapse_trivial_axes(Mesh(shape, rank=0), axes) == jcollapse(jmesh, axes)
