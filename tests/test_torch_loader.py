"""The port's checkpoint loader against the JAX package's and the
``safetensors`` package.

Tiny ``transformers`` Llama checkpoints (``save_pretrained``: untied,
tied, and with ``attention_bias``) load into the same trees in both
packages: exact, f32 values and bf16 bit patterns alike.  With
``quantize=True`` the int8 ``q`` and the f32 ``s`` equal the reference
scheme (the JAX ``quantize_params`` of the JAX-loaded tree) exactly; the
JAX quantize-at-load path runs the scheme under ``jax.jit``, where XLA
turns its two divisions into reciprocal products, so against that tree
``q`` is within one int8 level and ``s`` within one bf16 ulp.  Round
trips go both ways between the two ``save_params``; the port's reader and
writer are held to ``safetensors``' own.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
transformers = pytest.importorskip("transformers")
safetensors = pytest.importorskip("safetensors")
import jax.numpy as jnp  # noqa: E402
from safetensors import safe_open  # noqa: E402
from safetensors.torch import save_file  # noqa: E402

from operator_tpu.models import configs as jax_configs  # noqa: E402
from operator_tpu.models import loader as jax_loader  # noqa: E402
from operator_tpu.models import quant as jax_quant  # noqa: E402
from operator_tpu_torch.models import configs, loader, quant  # noqa: E402

DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _configs(kind: str):
    extra = {"tied": {"tie_embeddings": True}, "bias": {"attention_bias": True}}.get(kind, {})
    return (dataclasses.replace(configs.TINY_TEST, **extra),
            dataclasses.replace(jax_configs.TINY_TEST, **extra))


def hf_checkpoint(path, kind: str = "untied", seed: int = 0, dtype=torch.float32,
                  cfg=configs.TINY_TEST) -> str:
    """A ``save_pretrained`` Llama checkpoint at ``cfg``'s shapes
    (``tiny-test``'s by default), random init from ``seed``."""
    torch.manual_seed(seed)
    hf = transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        intermediate_size=cfg.intermediate_size, num_hidden_layers=cfg.num_layers,
        num_attention_heads=cfg.num_heads, num_key_value_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
        max_position_embeddings=cfg.max_seq_len,
        tie_word_embeddings=kind == "tied", attention_bias=kind == "bias",
    )).to(dtype)
    with torch.no_grad():  # non-trivial norms and biases
        for name, p in hf.named_parameters():
            if name.endswith("norm.weight") or name.endswith(".bias"):
                p.copy_(torch.randn_like(p))
    hf.save_pretrained(str(path), safe_serialization=True)
    return str(path)


def _bits(value) -> np.ndarray:
    """Exact comparison form: bf16 as its 16 bits, others as they are."""
    if isinstance(value, torch.Tensor):
        if value.dtype == torch.bfloat16:
            return value.view(torch.int16).numpy().view(np.uint16)
        return value.numpy()
    array = np.asarray(value)
    return array.view(np.uint16) if array.dtype.name == "bfloat16" else array


def assert_trees_equal(got, want, path="") -> None:
    if isinstance(got, dict):
        assert set(got) == set(want), (path, sorted(got), sorted(want))
        for key in got:
            assert_trees_equal(got[key], want[key], f"{path}/{key}")
        return
    a, b = _bits(got), _bits(want)
    assert a.shape == b.shape and a.dtype == b.dtype, (path, a.shape, b.shape, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=path)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kind", ["untied", "tied", "bias"])
def test_load_params_matches_jax(tmp_path, kind, dtype):
    path = hf_checkpoint(tmp_path / kind, kind)
    cfg, jax_cfg = _configs(kind)
    torch_dtype, jax_dtype = DTYPES[dtype]
    got = loader.load_params(path, cfg, torch_dtype, device="cpu")
    want = jax_loader.load_params(path, jax_cfg, jax_dtype)
    assert_trees_equal(got, want)
    assert ("lm_head" in got) == (kind != "tied")
    assert ("bq" in got["layers"]) == (kind == "bias")


def test_convert_hf_state_dict_matches_jax():
    torch.manual_seed(1)
    cfg = configs.TINY_TEST
    hf = transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        intermediate_size=cfg.intermediate_size, num_hidden_layers=cfg.num_layers + 1,
        num_attention_heads=cfg.num_heads, num_key_value_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim, tie_word_embeddings=False))
    state = hf.state_dict()  # one layer more than the config: a prefix loads
    got = loader.convert_hf_state_dict(state, cfg, torch.float32, device="cpu")
    want = jax_loader.convert_hf_state_dict(state, jax_configs.TINY_TEST, jnp.float32)
    assert_trees_equal(got, want)


def test_quantize_at_load_matches_the_reference_scheme(tmp_path):
    path = hf_checkpoint(tmp_path / "ck", "untied")
    got = loader.load_params(path, configs.TINY_TEST, device="cpu", quantize=True)
    want_float = jax_loader.load_params(path, jax_configs.TINY_TEST, jnp.bfloat16)
    want = jax_quant.quantize_params(want_float, jax_configs.TINY_TEST)
    assert_trees_equal(got, want)  # q byte for byte, s exact
    jitted = jax_loader.load_params(path, jax_configs.TINY_TEST, jnp.bfloat16, quantize=True)
    for name in quant.QUANTIZED_LAYER_MATRICES:
        q, s = got["layers"][name]["q"].numpy(), got["layers"][name]["s"].numpy()
        jq, js = np.asarray(jitted["layers"][name]["q"]), np.asarray(jitted["layers"][name]["s"])
        assert np.abs(q.astype(np.int32) - jq).max() <= 1, name
        np.testing.assert_allclose(s, js, rtol=2.0 ** -8, atol=0, err_msg=name)
    assert quant.is_quantized(got)
    assert quant.quantized_bytes(got) == jax_quant.quantized_bytes(want)
    assert_trees_equal(quant.dequantize_params(got), jax_quant.dequantize_params(want))


def test_load_params_async_equals_the_synchronous_load(tmp_path):
    path = hf_checkpoint(tmp_path / "ck", "untied")
    handle = loader.load_params_async(path, configs.TINY_TEST, device="cpu", quantize=True)
    got = handle.result(timeout=120)
    assert handle.done() and handle.seconds is not None and handle.seconds > 0
    assert_trees_equal(got, loader.load_params(path, configs.TINY_TEST, device="cpu",
                                               quantize=True))
    failing = loader.load_params_async(str(tmp_path / "absent"), configs.TINY_TEST, device="cpu")
    with pytest.raises(FileNotFoundError):
        failing.result(timeout=60)


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_save_params_round_trips_through_the_other_package(tmp_path, direction, dtype):
    source = hf_checkpoint(tmp_path / "hf", "bias")
    cfg, jax_cfg = _configs("bias")
    torch_dtype, jax_dtype = DTYPES[dtype]
    out = str(tmp_path / "saved")
    if direction == "port_to_jax":
        params = loader.load_params(source, cfg, torch_dtype, device="cpu")
        files = loader.save_params(params, out, cfg, shard_bytes=64 << 10)
        back = jax_loader.load_params(out, jax_cfg, jax_dtype)
    else:
        params = jax_loader.load_params(source, jax_cfg, jax_dtype)
        files = jax_loader.save_params(params, out, jax_cfg, shard_bytes=64 << 10)
        back = loader.load_params(out, cfg, torch_dtype, device="cpu")
    assert len(files) > 1 and all(f.endswith(f"-of-{len(files):05d}.safetensors") for f in files)
    with open(os.path.join(out, "model.safetensors.index.json")) as fh:
        index = json.load(fh)
    assert sorted(set(index["weight_map"].values())) == sorted(files)
    assert_trees_equal(back, params)


def test_save_params_names_and_shards_as_jax(tmp_path):
    source = hf_checkpoint(tmp_path / "hf", "untied")
    params = loader.load_params(source, configs.TINY_TEST, torch.float32, device="cpu")
    jax_params = jax_loader.load_params(source, jax_configs.TINY_TEST, jnp.float32)
    got = loader.save_params(params, str(tmp_path / "port"), configs.TINY_TEST,
                             shard_bytes=100_000)
    want = jax_loader.save_params(jax_params, str(tmp_path / "jax"), jax_configs.TINY_TEST,
                                  shard_bytes=100_000)
    assert got == want
    indexes = [json.load(open(tmp_path / side / "model.safetensors.index.json"))
               for side in ("port", "jax")]
    assert indexes[0] == indexes[1]


def test_save_params_refuses_quantized_trees(tmp_path):
    source = hf_checkpoint(tmp_path / "hf", "untied")
    params = loader.load_params(source, configs.TINY_TEST, device="cpu", quantize=True)
    with pytest.raises(ValueError, match="dequantize_params") as got:
        loader.save_params(params, str(tmp_path / "out"), configs.TINY_TEST)
    jax_params = jax_loader.load_params(source, jax_configs.TINY_TEST, quantize=True)
    with pytest.raises(ValueError) as want:
        jax_loader.save_params(jax_params, str(tmp_path / "out2"), jax_configs.TINY_TEST)
    assert str(got.value) == str(want.value)
    merged = {**params, "layers": {**params["layers"], "wq": quant.dequantize_params(
        params)["layers"]["wq"]}}  # partly merged: still int8 elsewhere
    with pytest.raises(ValueError):
        loader.save_params(merged, str(tmp_path / "out3"), configs.TINY_TEST)


@pytest.mark.parametrize("drop", ["model.layers.1.mlp.up_proj.weight", "lm_head.weight"])
def test_an_incomplete_checkpoint_raises_as_jax(tmp_path, drop):
    source = hf_checkpoint(tmp_path / "hf", "untied")
    tensors = dict(loader.iter_safetensors(source))
    del tensors[drop]
    out = tmp_path / "incomplete"
    out.mkdir()
    save_file({k: v.clone() for k, v in tensors.items()}, str(out / "model.safetensors"))
    with pytest.raises(ValueError) as got:
        loader.load_params(str(out), configs.TINY_TEST, device="cpu")
    with pytest.raises(ValueError) as want:
        jax_loader.load_params(str(out), jax_configs.TINY_TEST)
    assert str(got.value) == str(want.value)
    with pytest.raises(FileNotFoundError):
        loader.load_params(str(tmp_path), configs.TINY_TEST, device="cpu")


def _mixed_tensors() -> dict:
    gen = torch.Generator().manual_seed(5)
    return {
        "bf16": torch.randn(3, 5, generator=gen).to(torch.bfloat16),
        "f16": torch.randn(7, generator=gen).to(torch.float16),
        "f32": torch.randn(2, 3, 4, generator=gen),
        "f64": torch.randn(3, generator=gen, dtype=torch.float64),
        "i8": torch.randint(-128, 127, (5, 3), generator=gen, dtype=torch.int8),
        "u8": torch.randint(0, 255, (9,), generator=gen, dtype=torch.uint8),
        "i32": torch.randint(-1000, 1000, (4,), generator=gen, dtype=torch.int32),
        "i64": torch.randint(-1000, 1000, (2, 2), generator=gen, dtype=torch.int64),
        "bool": torch.rand(6, generator=gen) > 0.5,
        "scalar": torch.tensor(3.5),
        "empty": torch.zeros(0, 4),
    }


def test_the_reader_reads_safetensors_output_byte_for_byte(tmp_path):
    tensors = _mixed_tensors()
    path = str(tmp_path / "lib.safetensors")
    save_file(tensors, path, metadata={"format": "pt"})
    got = dict(loader.read_safetensors(path))
    assert sorted(got) == sorted(tensors)
    for name, want in tensors.items():
        assert got[name].dtype == want.dtype and got[name].shape == want.shape, name
        assert got[name].reshape(-1).view(torch.uint8).tolist() == \
            want.reshape(-1).view(torch.uint8).tolist(), name


def test_the_writer_is_read_by_safetensors(tmp_path):
    tensors = _mixed_tensors()
    path = str(tmp_path / "port.safetensors")
    loader.write_safetensors(path, tensors)
    with open(path, "rb") as fh:
        header_len = int.from_bytes(fh.read(8), "little")
        assert header_len % 8 == 0  # padded with spaces, as the spec asks
        assert fh.read(header_len).decode().endswith(("}", " "))
    with safe_open(path, framework="pt") as fh:
        assert sorted(fh.keys()) == sorted(tensors)
        for name, want in tensors.items():
            got = fh.get_tensor(name)
            assert got.dtype == want.dtype and torch.equal(got, want), name
    back = dict(loader.read_safetensors(path))
    assert all(torch.equal(back[name], want) for name, want in tensors.items())
