"""The port's sharding rules, ``scatter_clients_shard``, interconnect
formula and ``default_policy`` against the reference's.

* ``repro_torch.sharding.rules`` leaf by leaf against
  ``repro.sharding.rules``: the server, client (stacked cohort), mask
  and cache trees of every arch of ``list_archs()``, reduced and built
  by the port, against the reference's specs of the reference's
  abstract trees of the same config, at (data, model) sizes (1, 1),
  (2, 2) and (2, 4), FSDP and ZeRO on and off; the same at full size
  over the reference's abstract shapes (where FSDP and ZeRO engage:
  leaves of 4 M elements and more); ``cohort_pspecs``' divisibility
  fallback and ``staged_cohort_spec``.
* ``masks.scatter_clients_shard`` against the reference's on random
  trees, selections and offsets.
* ``AdaSplitTrainer._iteration_interconnect_bytes`` against the
  reference trainer's, with ``_shard`` and ``_ax`` set on both in the
  test only (the reference's sharded run cannot run here).
* ``launch.steps.default_policy`` against the reference's for every
  arch and input shape of the configs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

from repro.configs.base import INPUT_SHAPES
from repro.configs.base import get_config as jget_config
from repro.core import masks as jmasks
from repro.core.adasplit import AdaSplitHParams as JHParams
from repro.core.adasplit import AdaSplitTrainer as JTrainer
from repro.launch.steps import default_policy as jdefault_policy
from repro.models import decode as jdecode
from repro.models import transformer as jtfm
from repro.sharding import rules as jrules
from repro_torch.configs.base import InputShape
from repro_torch.configs.base import get_config as tget_config
from repro_torch.configs.base import list_archs
from repro_torch.core import masks as tmasks
from repro_torch.core.adasplit import AdaSplitHParams, AdaSplitTrainer
from repro_torch.data.synthetic import ClientData, mixed_noniid
from repro_torch.launch.mesh import make_cohort_mesh, make_host_mesh
from repro_torch.launch.steps import LaunchPolicy, default_policy
from repro_torch.models import decode as tdecode
from repro_torch.models import transformer as ttfm
from repro_torch.sharding import rules as trules

SIZES = [(1, 1), (2, 2), (2, 4)]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _axes(data, model):
    return (jrules.MeshAxes(model="model", data=("data",), model_size=model,
                            data_size=data),
            trules.MeshAxes(model="model", data=("data",), model_size=model,
                            data_size=data))


def _jflat(specs):
    """{path: spec tuple} of a reference spec tree."""
    out = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]:
        out[tuple(str(e.key) if hasattr(e, "key") else f"[{e.idx}]"
                  for e in path)] = tuple(spec)
    return out


def _tflat(specs, path=()):
    """{path: spec tuple} of a port spec tree."""
    if isinstance(specs, dict):
        return {k: v for key in specs
                for k, v in _tflat(specs[key], path + (str(key),)).items()}
    if isinstance(specs, list):
        return {k: v for i, s in enumerate(specs)
                for k, v in _tflat(s, path + (f"[{i}]",)).items()}
    assert isinstance(specs, trules.P), specs
    return {path: tuple(specs)}


def _stack2(tree):
    """A stacked cohort of 2 (a leading dim on every leaf)."""
    if isinstance(tree, dict):
        return {k: _stack2(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_stack2(v) for v in tree]
    return torch.stack([tree, tree])


@pytest.fixture(scope="module")
def reduced_trees():
    """Per arch: (reference cfg, port cfg, the reference's abstract
    trees, the port's trees) of the reduced config."""
    out = {}
    for arch in list_archs():
        jcfg, tcfg = jget_config(arch).reduced(), tget_config(arch).reduced()
        key = jax.random.PRNGKey(0)
        gen = torch.Generator().manual_seed(0)
        j = {"server": jax.eval_shape(
                lambda: jtfm.init_server_params(jcfg, key)),
             "client": jax.eval_shape(lambda: jax.tree.map(
                 lambda x: jnp.stack([x, x]),
                 jtfm.init_client_params(jcfg, key))),
             "masks": jax.eval_shape(
                 lambda: jmasks.init_unit_masks(jcfg, 4)),
             "cache": jax.eval_shape(
                 lambda: jdecode.init_cache(jcfg, 2, 16, src_len=8
                                            if jcfg.is_encoder_decoder
                                            else 0))}
        t = {"server": ttfm.init_server_params(tcfg, gen),
             "client": _stack2(ttfm.init_client_params(tcfg, gen)),
             "masks": tmasks.init_unit_masks(tcfg, 4, device="cpu"),
             "cache": tdecode.init_cache(tcfg, 2, 16, device="cpu",
                                         src_len=8 if tcfg.is_encoder_decoder
                                         else 0)}
        out[arch] = (jcfg, tcfg, j, t)
    return out


def _all_specs(rules, cfg, trees, ax, fsdp, zero):
    server = rules.server_pspecs(cfg, trees["server"], ax, fsdp=fsdp)
    return {"server": server,
            "opt": rules.opt_pspecs(server, trees["server"], ax, zero=zero),
            "client": rules.client_pspecs(cfg, trees["client"], ax),
            "masks": rules.mask_pspecs(cfg, trees["masks"], ax),
            "cache": rules.cache_pspecs(cfg, trees["cache"], ax),
            "cache_nobatch": rules.cache_pspecs(cfg, trees["cache"], ax,
                                                batch_shardable=False),
            "cohort": rules.cohort_pspecs(trees["masks"], ax,
                                          cohort_size=4)}


@pytest.mark.parametrize("fsdp,zero", [(False, False), (True, True),
                                       (False, True)])
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"d{s[0]}m{s[1]}")
@pytest.mark.parametrize("arch", list_archs())
def test_rules_match_reference_on_port_trees(reduced_trees, arch, size,
                                             fsdp, zero):
    jcfg, tcfg, j, t = reduced_trees[arch]
    jax_ax, t_ax = _axes(*size)
    want = _all_specs(jrules, jcfg, j, jax_ax, fsdp, zero)
    got = _all_specs(trules, tcfg, t, t_ax, fsdp, zero)
    for part in want:
        assert _tflat(got[part]) == _jflat(want[part]), part


@pytest.mark.parametrize("size", [(2, 2), (4, 16), (16, 16)],
                         ids=lambda s: f"d{s[0]}m{s[1]}")
@pytest.mark.parametrize("arch", list_archs())
def test_rules_match_reference_at_full_size(arch, size):
    """FSDP / ZeRO engage only on leaves of 4 M elements and more: the
    published configs' shapes (the reference's abstract trees, read by
    both rule sets)."""
    jcfg = jget_config(arch)
    key = jax.random.PRNGKey(0)
    server = jax.eval_shape(lambda: jtfm.init_server_params(jcfg, key))
    jax_ax, t_ax = _axes(*size)
    for fsdp in (False, True):
        want = jrules.server_pspecs(jcfg, server, jax_ax, fsdp=fsdp)
        got = trules.server_pspecs(tget_config(arch), server, t_ax,
                                   fsdp=fsdp)
        assert _tflat(got) == _jflat(want)
        assert _tflat(trules.opt_pspecs(got, server, t_ax)) == \
            _jflat(jrules.opt_pspecs(want, server, jax_ax))
    assert any(s is not None for spec in _tflat(got).values() for s in spec)


@pytest.mark.parametrize("data", [1, 2, 4, 6])
def test_cohort_pspecs_divisibility_fallback(data):
    tree = {"a": np.zeros((6, 3), np.float32), "b": np.zeros((6,)),
            "t": np.zeros(()), "other": np.zeros((4, 2))}
    jax_ax, t_ax = _axes(data, 1)
    for size in (None, 6):
        want = jrules.cohort_pspecs(tree, jax_ax, cohort_size=size)
        got = trules.cohort_pspecs(tree, t_ax, cohort_size=size)
        assert _tflat(got) == _jflat(want)
    # scalars and non-dividing leading dims stay replicated
    assert trules.cohort_pspecs(tree, t_ax)["t"] == ()
    if data == 4:
        assert trules.cohort_pspecs(tree, t_ax)["a"] == ()
        assert trules.cohort_pspecs(tree, t_ax)["other"] == ("data", None)


@pytest.mark.parametrize("ndim,cohort_dim", [(4, 1), (5, 1), (5, 2),
                                             (6, 2)])
def test_staged_cohort_spec_and_batch_spec(ndim, cohort_dim):
    jax_ax, t_ax = _axes(2, 1)
    assert tuple(trules.staged_cohort_spec(t_ax, ndim, cohort_dim=cohort_dim)) \
        == tuple(jrules.staged_cohort_spec(jax_ax, ndim,
                                           cohort_dim=cohort_dim))
    assert tuple(trules.batch_spec(t_ax, ndim)) == \
        tuple(jrules.batch_spec(jax_ax, ndim))
    multi = trules.MeshAxes(data=("pod", "data"), data_size=4)
    assert trules.batch_spec(multi, 2) == (("pod", "data"), None)


def test_mesh_axes_from_the_port_mesh():
    for mesh, names in ((make_host_mesh(device="cpu"), ("data", "model")),
                        (make_cohort_mesh(device="cpu"), ("data",))):
        assert mesh.axis_names == names and mesh.world == 1
        ax = trules.MeshAxes.from_mesh(mesh)
        assert (ax.data, ax.data_size, ax.model_size) == (("data",), 1, 1)
        assert ax.model == ("model" if "model" in names else None)


@pytest.mark.parametrize("seed", range(6))
def test_scatter_clients_shard_matches_reference(seed):
    rng = np.random.default_rng(seed)
    C, world = 8, [2, 4][seed % 2]
    size = C // world
    S = int(rng.integers(1, C + 1))
    idx = np.sort(rng.choice(C, S, replace=False)).astype(np.int32)
    shapes = {"w": (3,), "m": (2, 5), "step": ()}
    for r in range(world):
        tree = {k: rng.normal(size=(size,) + s).astype(np.float32)
                for k, s in shapes.items()}
        tree["step"] = tree["step"].astype(np.int32)
        new = {k: rng.normal(size=(S,) + s).astype(np.float32)
               for k, s in shapes.items()}
        want = jmasks.scatter_clients_shard(
            jax.tree.map(jnp.asarray, tree), jnp.asarray(idx),
            jax.tree.map(jnp.asarray, new), offset=r * size, size=size)
        got = tmasks.scatter_clients_shard(
            {k: torch.from_numpy(v) for k, v in tree.items()},
            torch.from_numpy(idx.astype(np.int64)),
            {k: torch.from_numpy(v) for k, v in new.items()},
            offset=r * size, size=size)
        for k in shapes:
            assert got[k].dtype == torch.from_numpy(tree[k]).dtype
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]))


def _clients(n, size=16):
    ref = mixed_noniid(n_clients=n, n_per_client=32, n_test=8, seed=0)
    for c in ref:
        c.x, c.test_x = c.x[:, :size, :size], c.test_x[:, :size, :size]
    return ref, [ClientData(c.x, c.y, c.test_x, c.test_y, c.dataset_id)
                 for c in ref]


@pytest.mark.parametrize("kw", [dict(), dict(mask_mode="per_scalar"),
                                dict(server_grad_to_client=True),
                                dict(act_l1=0.1)],
                         ids=["per_unit", "per_scalar", "joint", "act_l1"])
@pytest.mark.parametrize("world", [2, 4])
def test_interconnect_formula_matches_reference(kw, world):
    small = dict(image_size=16, conv_channels=(4, 8, 8))
    jclients, tclients = _clients(4)
    ref = JTrainer(dataclasses.replace(jget_config("lenet-cifar"), **small),
                   JHParams(batch_size=8, **kw), jclients)
    tr = AdaSplitTrainer(dataclasses.replace(tget_config("lenet-cifar"),
                                             **small),
                         AdaSplitHParams(batch_size=8, **kw), tclients,
                         device="cpu")
    ref._shard, ref._ax = True, jrules.MeshAxes(data_size=world)
    tr._shard, tr._ax = True, trules.MeshAxes(data_size=world)
    assert tr._iteration_interconnect_bytes() == \
        ref._iteration_interconnect_bytes() > 0


def test_interconnect_at_full_width():
    """lenet-cifar at published widths, C=32, B=32: 6,441,728 B a global
    iteration for each rank past the first.  The reference's bill is
    linear in C, so its trainer is built at C=4 (its init draws client
    by client) and scaled by 8."""
    ref = JTrainer(jget_config("lenet-cifar"), JHParams(batch_size=32),
                   mixed_noniid(n_clients=4, n_per_client=32, n_test=8,
                                seed=0))
    tr = AdaSplitTrainer(tget_config("lenet-cifar"),
                         AdaSplitHParams(batch_size=32),
                         mixed_noniid(n_clients=32, n_per_client=32,
                                      n_test=8, seed=0), device="cpu")
    for world in (2, 4):
        ref._shard, ref._ax = True, jrules.MeshAxes(data_size=world)
        tr._shard, tr._ax = True, trules.MeshAxes(data_size=world)
        assert tr._iteration_interconnect_bytes() == \
            8 * ref._iteration_interconnect_bytes() == (world - 1) * 6_441_728


@pytest.mark.parametrize("data_size", [1, 4, 16])
@pytest.mark.parametrize("arch", list_archs(include_paper=True))
def test_default_policy_matches_reference(arch, data_size):
    shapes = [None] + [InputShape(s.name, s.seq_len, s.global_batch, s.kind)
                       for s in INPUT_SHAPES.values()]
    for shape in shapes:
        want = jdefault_policy(jget_config(arch), shape and INPUT_SHAPES[
            shape.name], data_size)
        got = default_policy(tget_config(arch), shape, data_size)
        assert got.microbatch == want.microbatch, (arch, shape)
        for f in dataclasses.fields(LaunchPolicy):
            assert getattr(got, f.name) == getattr(want, f.name), f.name
