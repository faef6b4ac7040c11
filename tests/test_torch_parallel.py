"""The port's mesh layer (``operator_tpu_torch/parallel/mesh.py``) and
LoRA's specs against the JAX package's, in one process.

Mirrors of the planning tests of ``tests/test_parallel.py``, then the
plans, every spec function, ``lora_specs`` and
``validate_param_shardings`` held leaf for leaf to the JAX functions
(``PartitionSpec`` and ``P`` both compared as tuples), and the port's
own parts: specs to DTensor placements, and the refusal of a mesh
larger than the process group (one process per rank).
"""

from __future__ import annotations

import dataclasses

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
from jax.sharding import PartitionSpec  # noqa: E402

from operator_tpu.models import get_config as jax_get_config  # noqa: E402
from operator_tpu.parallel import lora as jax_lora  # noqa: E402
from operator_tpu.parallel import mesh as jax_mesh  # noqa: E402
from operator_tpu_torch.models import TINY_TEST, get_config  # noqa: E402
from operator_tpu_torch.models.llama import init_params  # noqa: E402
from operator_tpu_torch.parallel import (  # noqa: E402
    MeshPlan,
    P,
    batch_spec,
    kv_cache_spec,
    logits_spec,
    lora_specs,
    make_mesh,
    mesh_summary,
    paged_cache_specs,
    param_specs,
    placements,
    plan_for,
    validate_param_shardings,
)
from operator_tpu_torch.parallel.mesh import tree_map, tree_structure  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402

MODELS = ("tiny-test", "tinyllama-1.1b", "llama-3-8b", "llama-3.1-8b", "llama-3.2-1b",
          "llama-3.2-3b", "mistral-7b", "qwen2.5-7b", "qwen2.5-1.5b")


def _jax_tuples(tree):
    return jax.tree_util.tree_map(tuple, tree, is_leaf=lambda x: isinstance(x, PartitionSpec))


def _tuples(tree):
    return tree_map(tuple, tree)


# --- planning (tests/test_parallel.py) ------------------------------------


def test_plan_defaults_to_dp():
    assert plan_for(8) == MeshPlan(dp=8, fsdp=1, tp=1)


def test_plan_llama3_8b_needs_tp_on_v5e():
    # bf16 8B is about 16 GB, over the 14 GB fallback budget: tp = 2
    plan = plan_for(4, config=get_config("llama-3-8b"))
    assert plan.tp >= 2
    assert plan.total == 4


def test_plan_small_model_stays_dp():
    plan = plan_for(8, config=get_config("tinyllama-1.1b"))
    assert plan.tp == 1 and plan.dp == 8


def test_plan_rejects_oversubscription():
    with pytest.raises(ValueError):
        plan_for(4, tp=4, fsdp=2)


def test_param_specs_cover_all_params():
    params = init_params(TINY_TEST, None, device="meta")
    assert tree_structure(params) == tree_structure(param_specs(TINY_TEST))


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("n_devices", [1, 2, 4, 8, 16])
def test_plan_matches_jax(name, n_devices):
    got = plan_for(n_devices, config=get_config(name), devices=["cpu"])
    want = jax_mesh.plan_for(n_devices, config=jax_get_config(name))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("kw", [{"tp": 2}, {"tp": 2, "fsdp": 2}, {"fsdp": 4}, {"tp": 1}])
def test_explicit_plan_matches_jax(kw):
    assert dataclasses.asdict(plan_for(8, **kw)) == dataclasses.asdict(jax_mesh.plan_for(8, **kw))


# --- specs ------------------------------------------------------------------


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("shard_fsdp", [True, False])
def test_param_specs_match_jax(name, quantized, shard_fsdp):
    got = param_specs(get_config(name), quantized=quantized, shard_fsdp=shard_fsdp)
    want = jax_mesh.param_specs(jax_get_config(name), quantized=quantized, shard_fsdp=shard_fsdp)
    assert _tuples(got) == _jax_tuples(want)


def test_run_time_specs_match_jax():
    for got, want in ((batch_spec(), jax_mesh.batch_spec()),
                      (kv_cache_spec(), jax_mesh.kv_cache_spec()),
                      (logits_spec(), jax_mesh.logits_spec())):
        assert isinstance(got, P) and tuple(got) == tuple(want)
    got, want = paged_cache_specs(), jax_mesh.paged_cache_specs()
    for field in ("k_pages", "v_pages", "page_table", "lengths"):
        assert tuple(getattr(got, field)) == tuple(getattr(want, field))


@pytest.mark.parametrize("targets", [("wq", "wk", "wv", "wo"),
                                     ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")])
@pytest.mark.parametrize("name", ["tiny-test", "llama-3-8b", "qwen2.5-7b"])
def test_lora_specs_match_jax(name, targets):
    got = lora_specs(get_config(name), targets)
    want = jax_lora.lora_specs(jax_get_config(name), targets)
    assert _tuples(got) == _jax_tuples(want)
    # row-parallel wo: fan-in on tp, fan-out on fsdp
    assert got["wo"]["a"] == P(None, "tp", None)
    assert got["wo"]["b"] == P(None, None, "fsdp")


# --- validate_param_shardings ------------------------------------------------


def _jax_validate(plan: MeshPlan, name: str, quantized: bool):
    mesh = jax_mesh.make_mesh(jax_mesh.MeshPlan(**dataclasses.asdict(plan)),
                              devices=jax.devices("cpu")[:plan.total])
    try:
        return jax_mesh.validate_param_shardings(mesh, jax_get_config(name), quantized=quantized)
    except ValueError:
        return "raises"


def _port_validate(plan: MeshPlan, name: str, quantized: bool):
    try:
        return validate_param_shardings(plan, get_config(name), quantized=quantized)
    except ValueError:
        return "raises"


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("name", ["llama-3-8b", "qwen2.5-7b", "mistral-7b", "llama-3.2-3b"])
@pytest.mark.parametrize("plan", [MeshPlan(dp=2, tp=4), MeshPlan(fsdp=2, tp=4),
                                  MeshPlan(fsdp=3), MeshPlan(tp=3), MeshPlan(fsdp=8)],
                         ids=["tp4_dp2", "tp4_fsdp2", "fsdp3", "tp3", "fsdp8"])
def test_validate_param_shardings_agrees_with_jax(plan, name, quantized):
    assert _port_validate(plan, name, quantized) == _jax_validate(plan, name, quantized)


def test_validate_param_shardings_names_the_dim():
    assert validate_param_shardings(MeshPlan(dp=2, tp=4), get_config("llama-3-8b")) > 10
    with pytest.raises(ValueError, match="partitions axis 1 3 ways.*4096"):
        validate_param_shardings(MeshPlan(fsdp=3), get_config("llama-3-8b"))


def test_validate_param_shardings_on_a_mesh_allocates_nothing():
    mesh = make_mesh(MeshPlan(), device_type="cpu")
    assert validate_param_shardings(mesh, get_config("llama-3-8b"), quantized=True) == 19


# --- placements and the mesh -----------------------------------------------


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(MeshPlan(), device_type="cpu")


def test_spec_to_placements(mesh):
    assert placements(P(None, "fsdp", "tp"), mesh) == (Replicate(), Shard(1), Shard(2))
    assert placements(P("fsdp", None), mesh) == (Replicate(), Shard(0), Replicate())
    # one dim over two axes: two Shard of it, the major (dp) first
    assert placements(batch_spec(), mesh) == (Shard(0), Shard(0), Replicate())
    assert placements(P(None), mesh) == (Replicate(),) * 3


@pytest.mark.parametrize("spec, match", [(P("model"), "axis 'model'"),
                                         (P(("fsdp", "dp")), "mesh's order"),
                                         (P("tp", "tp"), "twice")])
def test_bad_specs_are_refused(mesh, spec, match):
    with pytest.raises(ValueError, match=match):
        placements(spec, mesh)


def test_mesh_summary(mesh):
    assert mesh_summary(mesh) == "mesh {'dp': 1, 'fsdp': 1, 'tp': 1} over 1 cpu device(s)"
    assert tuple(mesh.mesh_dim_names) == ("dp", "fsdp", "tp")


def test_a_mesh_larger_than_the_group_is_refused(mesh):
    with pytest.raises(ValueError, match="one process per rank"):
        make_mesh(MeshPlan(dp=2, tp=4), device_type="cpu")
