"""The port's logical-axis sharding (``distributed/sharding.py``) against
the reference's.

The reference's five spec tests (``tests/test_sharding_analysis.py``)
in the port; then, for every arch of ``ARCH_IDS`` on both production
mesh shapes (16×16 and 2×16×16), every leaf of the full param tree, the
bf16 serving pool, the f32 train adapter and the decode cache gets the
reference's spec, path for path. Shapes come from the reference's
``jax.eval_shape`` and from the port's meta and fake inits; both sides
use a ``FakeMesh`` (a ``shape`` mapping and nothing else), so JAX needs
no 256 devices.

``logical_constraint`` is the identity without a mesh (and on a plain
tensor); on an 8-rank fake mesh (2×4, in a subprocess: a process group
is process-wide state) it redistributes a DTensor to the placements of
the reference's spec, rank mismatch included. The collectives that
DTensor issues for a matmul and three redistributions on that mesh are
counted at the bytes a hand computation gives (shapes only: the fake
group moves no data).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.distributed import sharding as JS  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed import sharding as S  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
DECODE_B, DECODE_LEN = 128, 32768   # decode_32k's cache


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape


MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


# ---------------------------------------------------------------------------
# the reference's spec tests, in the port
# ---------------------------------------------------------------------------


def test_logical_constraint_identity_without_mesh():
    x = torch.ones((4, 8))
    assert S.logical_constraint(x, "batch", None) is x
    with S.use_mesh(FakeMesh(MESHES["16x16"])):
        # a plain tensor on a mesh: still the identity, no op runs
        assert S.logical_constraint(x, "batch", None) is x


def test_spec_for_divisibility():
    mesh = FakeMesh({"model": 1})  # one device, 1-wide axes
    # dims divisible by 1 -> rule applies
    assert tuple(S.spec_for((16, 32), ("heads", None), mesh)) == ("model",
                                                                  None)


def test_spec_for_drops_nondividing():
    spec = S.spec_for((8, 128), ("kv_heads", "head_dim"),
                      FakeMesh(MESHES["16x16"]), S.LOGICAL_RULES)
    # kv_heads=8 % 16 != 0 -> dropped; head_dim=128 % 16 == 0 -> model
    assert tuple(spec) == (None, "model")


def test_spec_axis_used_once():
    spec = S.spec_for((32, 32), ("heads", "vocab"),
                      FakeMesh(MESHES["16x16"]), S.LOGICAL_RULES)
    # both map to 'model'; second must drop
    assert tuple(spec) == ("model", None)


def test_param_rules_paths():
    mesh = FakeMesh(MESHES["16x16"])
    assert tuple(S._leaf_spec("layers/slot0/attn/wq", (24, 8192, 1024),
                              mesh, S.LOGICAL_RULES)) == (None, "data",
                                                          "model")
    assert tuple(S._leaf_spec("cache/slot0/k", (24, 128, 4096, 8, 128),
                              mesh, S.LOGICAL_RULES)) == (
        None, "data", None, None, "model")
    assert tuple(S._leaf_spec("params/layers/slot0/moe/experts/up",
                              (24, 16, 512, 2048), mesh,
                              S.LOGICAL_RULES)) == (None, "model", "data",
                                                    None)


def test_rules_are_the_references():
    assert S.LOGICAL_RULES == JS.LOGICAL_RULES
    assert S.PARAM_RULES == JS.PARAM_RULES


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("shape,axes,rules", [
    ((256, 17, 4096), ("batch", None, "embed"), None),
    ((8, 14, 64), ("batch", "heads", None), None),
    ((4, 2048), ("batch", "ff"), {"replicate_below": 64e6}),
    ((32, 5, 8), ("batch", "kv_heads", "head_dim"), {"kv_seq": "model"}),
    ((6, 96), ("batch", "vocab"), None),
])
def test_spec_for_matches_reference(mesh_name, shape, axes, rules):
    mesh = FakeMesh(MESHES[mesh_name])
    rules = dict(S.LOGICAL_RULES, **(rules or {}))
    assert tuple(S.spec_for(shape, axes, mesh, rules)) == tuple(
        JS.spec_for(shape, axes, mesh, rules))


# ---------------------------------------------------------------------------
# every leaf of every arch: params, serving pool, train adapter, cache
# ---------------------------------------------------------------------------


def _ref_specs(tree, mesh):
    """path -> (shape, spec tuple) of the reference's ``param_specs``."""
    specs = JS.param_specs(tree, mesh)
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    sflat = jax.tree_util.tree_leaves(specs,
                                      is_leaf=lambda s: isinstance(s, JP))
    return {JS._path_str(p): (tuple(leaf.shape), tuple(s))
            for (p, leaf), s in zip(flat, sflat)}


def _port_specs(tree, mesh):
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        else:
            out[S._path_str(path)] = tuple(node.shape)

    walk(tree, ())
    specs = S.param_specs(tree, mesh)

    def get(path):
        node = specs
        for k in path.split("/"):
            node = node[k]
        return tuple(node)

    return {p: (shape, get(p)) for p, shape in out.items()}


@pytest.fixture(scope="module")
def arch_trees():
    """Each arch's trees in both packages: shapes only (eval_shape in the
    reference; meta, and fake for what the port draws or allocates)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    out = {}
    key = jax.random.PRNGKey(0)
    for arch in ARCH_IDS:
        jm = jax_build_model(jax_get_config(arch))
        n_pool = jm.cfg.lora.max_resident
        ref = {
            "params": jax.eval_shape(jm.init, key),
            "pool": jax.eval_shape(lambda k: jm.init_lora(
                k, n_slots=n_pool, dtype=jnp.bfloat16), key),
            "lora": jax.eval_shape(jm.init_lora, key),
            "cache": jax.eval_shape(lambda: jm.init_cache(DECODE_B,
                                                          DECODE_LEN)),
        }
        tm = build_model(get_config(arch), "cpu")
        gen = torch.Generator().manual_seed(0)
        with FakeTensorMode():
            port = {
                "params": tm._param_tree(None),
                "pool": tm.init_lora(gen, n_slots=n_pool,
                                     dtype=torch.bfloat16),
                "lora": tm.init_lora(gen),
                "cache": tm.init_cache(DECODE_B, DECODE_LEN),
            }
        out[arch] = (ref, port)
    return out


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_leaf_spec_matches_reference(arch_trees, arch, mesh_name):
    mesh = FakeMesh(MESHES[mesh_name])
    ref, port = arch_trees[arch]
    for part in ("params", "pool", "lora", "cache"):
        want = _ref_specs(ref[part], mesh)
        got = _port_specs(port[part], mesh)
        assert set(got) == set(want), (part, set(got) ^ set(want))
        assert got == want, (part, {p: (got[p], want[p]) for p in got
                                    if got[p] != want[p]})


# ---------------------------------------------------------------------------
# DTensor on an 8-rank fake mesh (subprocess)
# ---------------------------------------------------------------------------

_MESH_SCRIPT = r"""
import json, sys
import torch
from torch.distributed.tensor import Replicate, Shard
from repro_torch.distributed import sharding as S
from repro_torch.launch import analysis, mesh as M

mesh = M.make_mesh((2, 4), ("data", "model"))
out = {"constraint": [], "collectives": {}}
cases = json.loads(sys.argv[1])
with S.use_mesh(mesh):
    for shape, axes in cases:
        x = S.distribute_leaf(torch.zeros(shape), mesh,
                              (None,) * len(shape))
        y = S.logical_constraint(x, *axes)
        out["constraint"].append([str(p) for p in y.placements])
        assert tuple(y.shape) == tuple(shape)
    # a matmul [64, 32] @ [32, 48] with x sharded (data on rows, model on
    # the contraction) and w sharded (model on rows): partial sums over
    # 'model' reduce-scattered onto y's columns; then an all-gather
    x = S.distribute_leaf(torch.ones(64, 32), mesh, (("data",), "model"))
    w = S.distribute_leaf(torch.ones(32, 48), mesh, ("model", None))
    with analysis.collective_bytes() as mm:
        y = x @ w
        y = y.redistribute(mesh, [Shard(0), Shard(1)])
    with analysis.collective_bytes() as ag:
        y.redistribute(mesh, [Replicate(), Replicate()])
    with analysis.collective_bytes() as a2a:
        y.redistribute(mesh, [Shard(0), Shard(0)])
    # the same gather twice, the second as a fallback's
    with analysis.collective_bytes() as fb:
        y.redistribute(mesh, [Replicate(), Replicate()])
        with analysis.fallback_collectives():
            y.redistribute(mesh, [Replicate(), Replicate()])
    out["collectives"] = {"matmul": mm, "gather": ag, "alltoall": a2a,
                          "fallback": fb}
M.release_mesh()
print("RESULT:" + json.dumps(out))
"""

CASES = [((8, 16, 4, 32), ("batch", None, "heads", None)),
         ((8, 16, 3, 32), ("batch", None, "kv_heads", "head_dim")),
         ((8, 32), ("batch", None, None)),                # rank 2 < 3 axes
         ((8, 4, 12, 5), ("batch", "ff")),                # rank 4 > 2 axes
         ((6, 96), ("batch", "vocab"))]


def _run_mesh_script():
    # one thread: fake tensors compute nothing, and the suite's other
    # workers (real-timer serves among them) share the cores
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", _MESH_SCRIPT,
                           json.dumps(CASES)], capture_output=True,
                          text=True, timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [l for l in proc.stdout.splitlines() if l.startswith("RESULT:")]
    assert line, proc.stdout[-2000:]
    return json.loads(line[0][len("RESULT:"):])


@pytest.fixture(scope="module")
def mesh_result():
    return _run_mesh_script()


def _reference_placements(shape, axes, mesh_shape):
    """The reference's rank rule and spec, as DTensor placements."""
    n = len(shape)
    if len(axes) != n:
        if n < len(axes):
            keep_tail = n - 1
            axes = ((axes[0],) + axes[len(axes) - keep_tail:]) if keep_tail \
                else (axes[0],)
        else:
            axes = axes + (None,) * (n - len(axes))
    spec = JS.spec_for(shape, axes, FakeMesh(mesh_shape))
    out = []
    for name in mesh_shape:
        dims = [d for d, e in enumerate(spec)
                if e == name or (isinstance(e, tuple) and name in e)]
        out.append(f"S({dims[0]})" if dims else "R")
    return out


def test_logical_constraint_places_as_reference(mesh_result):
    for (shape, axes), got in zip(CASES, mesh_result["constraint"]):
        want = _reference_placements(tuple(shape), tuple(axes),
                                     {"data": 2, "model": 4})
        assert got == want, (shape, axes, got, want)


def test_collective_bytes_hand_computed(mesh_result):
    c = mesh_result["collectives"]
    # x @ w: x [32, 8] local (rows over data, contraction over model), w
    # [8, 48] local: a partial [32, 48] f32 per rank; to Shard(1) on
    # 'model' it is reduce-scattered: [32, 12] f32 per rank
    assert c["matmul"]["reduce-scatter"] == 32 * 12 * 4
    assert c["matmul"]["all-gather"] == c["matmul"]["all-reduce"] == 0
    assert c["matmul"]["count"] == 1
    # [Shard(0), Shard(1)] -> replicated: gather [32, 48] over model, then
    # [64, 48] over data (f32 result bytes per rank)
    assert c["gather"]["all-gather"] == (32 * 48 + 64 * 48) * 4
    assert c["gather"]["count"] == 2
    assert c["gather"]["total"] == c["gather"]["all-gather"]
    # [Shard(0), Shard(1)] -> [Shard(0), Shard(0)]: the model dim moves
    # from columns to rows, an all-to-all of a [8, 48] result, counted as
    # asked (the CPU group runs it as an all-gather and a chunk)
    assert c["alltoall"]["all-to-all"] == 8 * 48 * 4
    assert c["alltoall"]["all-gather"] == 0
    assert c["alltoall"]["count"] == 1


def test_fallback_collectives_split_out(mesh_result):
    """Collectives recorded within ``fallback_collectives`` (the dry-run's
    gathers around an op DTensor cannot place) are summed under
    ``fallback`` as well as under their kind; those outside are not."""
    c = mesh_result["collectives"]
    for case in ("matmul", "gather", "alltoall"):
        assert c[case]["fallback"] == 0, case
    gather = (32 * 48 + 64 * 48) * 4
    assert c["fallback"]["all-gather"] == c["fallback"]["total"] == 2 * gather
    assert c["fallback"]["fallback"] == gather
