"""The port's serving driver and converter vs the JAX reference.

Greedy ``generate`` on the CPU must give the reference's tokens on the
reduced recurrentgemma-2b config with the same parameters (handed over
through ``params_from_jax``) and the same prompts (made with numpy).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

from repro.configs import get_config as jget_config
from repro.distributed.axes import clear_logical_rules
from repro.launch.serve import generate as jgenerate
from repro.models import build_model as jbuild_model
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.launch.serve import generate, main
from repro_torch.models import build_model

torch.set_num_threads(2)

ARCH = "recurrentgemma-2b"


@pytest.fixture(autouse=True)
def _no_leaked_axis_rules():
    # an earlier test in this worker may leave logical-axis rules active,
    # which makes every JAX ``constrain`` call raise
    clear_logical_rules()


_JAX = {}


def _jax_params(cfg, seed):
    if (cfg, seed) not in _JAX:
        model = jbuild_model(cfg)
        _JAX[cfg, seed] = model, jax.jit(lambda r: model.init(r)[0])(jax.random.PRNGKey(seed))
    return _JAX[cfg, seed]


def _prompts(cfg, B, T0, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, T0).astype(np.int32) for _ in range(B)]


def test_greedy_generate_matches_jax():
    jcfg = jget_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    jmodel, jparams = _jax_params(jcfg, seed=3)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    prompts = _prompts(cfg, B=3, T0=11)          # longer than the window (8)
    kw = dict(max_new=10, max_len=11 + 10)
    want = jgenerate(jmodel, jparams, prompts, mesh=None, **kw)
    got = generate(build_model(cfg), params, prompts, device="cpu", **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0].shape == (21,)


def test_sampled_generate_is_seeded_and_in_vocab():
    cfg = get_config(ARCH).reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    prompts = _prompts(cfg, B=2, T0=6)

    def run(seed):
        return generate(model, params, prompts, max_new=8, max_len=14, temperature=1.0,
                        generator=torch.Generator().manual_seed(seed), device="cpu")

    a, b = run(1), run(1)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert all(((o >= 0) & (o < cfg.vocab_size)).all() for o in a)


def test_generate_rejects_overlong_request():
    cfg = get_config(ARCH).reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError):
        generate(model, params, _prompts(cfg, B=1, T0=6), max_new=8, max_len=10, device="cpu")


def test_serve_main_runs_on_cpu(capsys):
    outs = main(["--arch", ARCH, "--device", "cpu", "--max-new", "4", "--batch", "2"])
    assert len(outs) == 2 and "generated 8 tokens" in capsys.readouterr().out


def test_params_from_jax_bf16_round_trip():
    """bf16 leaves cross as raw 16-bit words: every bit survives, and the
    float32 leaves (norm scales, RG-LRU Λ) stay float32."""
    jcfg = jget_config(ARCH).reduced(dtype="bfloat16")
    cfg = get_config(ARCH).reduced(dtype="bfloat16")
    _, jparams = _jax_params(jcfg, seed=4)
    np_tree = jax.tree.map(np.asarray, jparams)
    params = params_from_jax(np_tree, cfg, device="cpu")
    np_leaves, treedef = jax.tree.flatten(np_tree)
    t_leaves, t_treedef = jax.tree.flatten(params)
    assert treedef == t_treedef
    kinds = set()
    for arr, t in zip(np_leaves, t_leaves):
        assert tuple(t.shape) == arr.shape
        kinds.add(str(arr.dtype))
        if arr.dtype.name == "bfloat16":
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(t.view(torch.int16).numpy(), arr.view(np.int16))
        else:
            assert t.dtype == torch.float32
            np.testing.assert_array_equal(t.numpy(), arr)
    assert kinds == {"bfloat16", "float32"}
    # and the converted bf16 model runs
    model = build_model(cfg)
    out = generate(model, params, _prompts(cfg, B=1, T0=5), max_new=2, max_len=7, device="cpu")
    assert out[0].shape == (7,)


def test_params_from_jax_rejects_a_tree_of_another_config():
    _, jparams = _jax_params(jget_config(ARCH).reduced(), seed=3)
    np_tree = jax.tree.map(np.asarray, jparams)
    with pytest.raises(ValueError):
        params_from_jax(np_tree, get_config(ARCH).reduced(n_layers=7), device="cpu")
