"""The port's decoder registry (dreamfusion_torch/models/decoders.py, with
models/osr.py's ShadowMLP and SeparateShadowMLP) against the JAX package's
(dreamfusion_tpu/models/decoders.py), on the CPU.

Every decoder of the JAX registry is initialised by flax on an input of
the width a field would feed it; the tree loads into the port's module
with strict=True (so every Linear is sized as flax sized its Dense from
the input), and the output and the gradients of every parameter and of
the input agree at 1e-5 of their largest entry. The noise ensembles of
RobustShadowMLP and RobustMLP take the JAX key's normals.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamfusion_tpu.models import decoders as jd
from dreamfusion_tpu.models import osr as _josr  # noqa: F401  (registers)

from dreamfusion_torch.models import decoders as td
from dreamfusion_torch.models import osr as _tosr  # noqa: F401  (registers)
from dreamfusion_torch.weights import from_jax_params

from test_torch_zoo import close

K0 = 6
# name -> (keyword arguments, input width)
CASES = {
    "resmlp": (dict(width=16, depth=4, k0_dim=K0), 20),
    "basicmlp": (dict(width=16, depth=4, k0_dim=K0), 20),
    "mlp": (dict(width=16, depth=2, k0_dim=K0), 11),
    "directshadowmlp": (dict(width=16, depth=3, k0_dim=K0), 20),
    "shadowv3mlp": (dict(width=16, depth=3, k0_dim=K0, shadow_dim=2), 20),
    "shadowv4mlp": (dict(width=16, depth=3, k0_dim=K0, shadow_dim=2), 20),
    "shadowv5mlp": (dict(width=16, depth=3, k0_dim=K0, shadow_dim=2), 20),
    "robustshadowmlp": (dict(width=16, depth=3, k0_dim=K0, shadow_dim=1,
                             ensemble=3), 20),
    "shadowrgimlp": (dict(width=16, depth=3, k0_dim=K0, shadow_dim=1), 20),
    "dvp_mlp": (dict(width=16, depth=3, k0_dim=K0, out_dim=4), 20),
    "robustmlp": (dict(width=16, depth=3, k0_dim=K0, ensemble=2), 20),
    "liif_mlp": (dict(width=16, depth=4, viewdir_dim=5, out_dim=4), 20),
    "shadowmlp": (dict(width=16, depth=3, k0_dim=K0), K0 + 9),
    "separateshadowmlp": (dict(width=16, depth=4, k0_dim=K0, shadow_dim=2),
                          K0 + 9),
}
NOISY = ("robustshadowmlp", "robustmlp")


def test_every_jax_decoder_is_registered():
    assert sorted(td.model_dict) == sorted(jd.model_dict) == sorted(CASES)
    for name, cls in jd.model_dict.items():
        assert td.model_dict[name].__name__ == cls.__name__, name


@pytest.mark.parametrize("name,noisy", [(n, False) for n in sorted(CASES)]
                         + [(n, True) for n in NOISY])
def test_decoder_matches(name, noisy):
    kw, in_dim = CASES[name]
    x = np.random.default_rng(0).normal(size=(7, in_dim)).astype(np.float32)
    jm = jd.get_MLP(name, **kw)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(1), x))
    tm = td.get_MLP(name, in_dim=in_dim, **kw)
    tm.load_state_dict(from_jax_params(params), strict=True)

    key = jax.random.PRNGKey(2)
    jkw = {"noise_key": key} if noisy else {}
    tkw = {}
    if noisy:       # the ensemble's members: split(key) -> one normal each
        width = K0 - kw.get("shadow_dim", 0) if name == "robustshadowmlp" \
            else K0
        tkw["noise"] = torch.from_numpy(np.stack([
            np.asarray(jax.random.normal(k, (7, width)))
            for k in jax.random.split(key, kw["ensemble"])]))

    def jloss(p, xx):
        y = jm.apply(p, xx, **jkw)
        return jnp.sum(y * jnp.arange(1.0, y.shape[-1] + 1)), y

    (_, ref), (gp, gx) = jax.value_and_grad(jloss, argnums=(0, 1),
                                            has_aux=True)(params, x)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tm(xt, **tkw)
    (y * torch.arange(1.0, y.shape[-1] + 1)).sum().backward()
    close(y, ref)
    close(xt.grad, gx)
    want = from_jax_params(jax.tree.map(np.asarray, gp))
    for n, p in tm.named_parameters():
        close(p.grad, want[n], err_msg=n)
