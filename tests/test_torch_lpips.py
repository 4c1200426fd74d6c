"""The port's LPIPS against the JAX package's, on the CPU in f32.

  * the value at 2 x 32x32 on carried parameters (the JAX package's
    `convert_lpips` of the port's seeded weights, and back through the
    port's `convert.lpips_from_flax`, bit for bit):
    rtol 1e-4 (the same VGG16 convs and reductions, summed in another order);
  * the gradient with respect to the first input against `jax.grad`: rtol
    1e-4 and atol 2e-5 of the gradient's largest magnitude (f32's own error
    against the f64 gradient is a few 1e-6 of it in both packages), and
    within 1e-5 of the port's own f64 gradient;
  * the three `.pth` layouts that the JAX package's `convert_lpips` takes
    load into the same module, with the `lpips` package's keys, through
    `load_lpips`; the port's own parameter file too; no path gives random
    weights that are frozen and seeded.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from resshift_tpu.models.lpips import LPIPS as JLPIPS, convert_lpips
from resshift_tpu_torch.checkpoint import save_params
from resshift_tpu_torch.convert import lpips_from_flax
from resshift_tpu_torch.models.lpips import LPIPS, _conv_indices, _slice_of, load_lpips

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def carried():
    """The port's seeded LPIPS (lin heads drawn, not ones), its parameters
    carried to JAX by the JAX package's `convert_lpips`, inputs."""
    model = load_lpips(None)
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for lin in model.lins:
            lin.model[1].weight.uniform_(0, 1, generator=gen)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    params = convert_lpips(sd)
    back = lpips_from_flax(params)  # and back through the port's converter
    assert set(back) == set(sd) and all(np.array_equal(back[k], sd[k]) for k in sd)
    rng = np.random.default_rng(0)
    x, y = (rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32) for _ in range(2))
    return params, model, x, y


def test_value_matches_jax(carried):
    params, model, x, y = carried
    want = np.asarray(jax.jit(JLPIPS().apply)({"params": params}, x, y))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    assert got.shape == (2,) and (got > 0).all()
    np.testing.assert_allclose(got, want, rtol=1e-4)
    with torch.no_grad():  # the distance of an image to itself
        assert float(model(torch.from_numpy(x), torch.from_numpy(x)).abs().max()) < 1e-6


def _input_grad(model, x, y, dtype):
    m = LPIPS(dtype).to(dtype)
    m.load_state_dict(model.state_dict())
    xt = torch.from_numpy(x).to(dtype).requires_grad_(True)
    m(xt, torch.from_numpy(y).to(dtype)).sum().backward()
    return xt.grad.double().numpy()


def test_input_gradient_matches_jax(carried):
    """Each f32 gradient is a few 1e-6 of the largest magnitude off the f64
    one (JAX's 2.5e-6, the port's 7.7e-6 with oneDNN's convs), so the two
    are held within 2e-5 of it, and the port's within 1e-5 of its f64
    gradient."""
    params, model, x, y = carried
    fn = lambda a: jnp.sum(JLPIPS().apply({"params": params}, a, jnp.asarray(y)))
    want = np.asarray(jax.jit(jax.grad(fn))(jnp.asarray(x)))
    got = _input_grad(model, x, y, torch.float32)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-5 * scale)
    exact = _input_grad(model, x, y, torch.float64)
    np.testing.assert_allclose(got, exact, rtol=1e-4, atol=1e-5 * scale)


def test_pth_layouts_load_the_same_module(carried, tmp_path):
    """The full lpips state_dict, torchvision's 'features.{idx}' prefix and
    the bare '{idx}' keys with 'lins.{i}' heads: one module, bit for bit."""
    _, model, x, y = carried
    sd = model.state_dict()
    vgg = {f"{i}.{k}": sd[f"net.slice{_slice_of(i)}.{i}.{k}"]
           for i in _conv_indices() for k in ("weight", "bias")}
    lins = {f"lin{i}.model.1.weight": sd[f"lin{i}.model.1.weight"] for i in range(5)}
    layouts = {"full": dict(sd),
               "features": {**{f"features.{k}": v for k, v in vgg.items()}, **lins},
               "bare": {**vgg, **{f"lins.{i}.model.1.weight": v for i, v in
                                  enumerate(lins.values())}}}
    with torch.no_grad():
        want = model(torch.from_numpy(x), torch.from_numpy(y))
    for name, layout in layouts.items():
        torch.save(layout, tmp_path / f"{name}.pth")
        loaded = load_lpips(tmp_path / f"{name}.pth")
        assert not any(p.requires_grad for p in loaded.parameters()) and not loaded.training
        for k, v in loaded.state_dict().items():
            assert torch.equal(v, sd[k]), (name, k)
        with torch.no_grad():
            assert torch.equal(loaded(torch.from_numpy(x), torch.from_numpy(y)), want)
    # a strict load of the lpips package's own keys, and the port's parameter file
    LPIPS().load_state_dict(sd)
    save_params(tmp_path / "own.pt", sd)
    assert all(torch.equal(v, sd[k]) for k, v in load_lpips(tmp_path / "own.pt")
               .state_dict().items())
    with pytest.raises(KeyError):
        torch.save({k: v for k, v in vgg.items() if not k.startswith("28.")}, tmp_path / "x.pth")
        load_lpips(tmp_path / "x.pth")


def test_random_weights_are_seeded_and_positive():
    a, b = load_lpips(None), load_lpips(None)
    for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(v, w), k
    rng = np.random.default_rng(1)
    x, y = (torch.from_numpy(rng.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32))
            for _ in range(2))
    with torch.no_grad():
        assert float(a(x, y)[0]) > 0
