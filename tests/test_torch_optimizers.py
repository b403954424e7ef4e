"""The port's nine optimizers against optax as the JAX package builds them
(`multiplanarunet_tpu.train.utils.init_optimizer`: Keras-style kwargs
translated, optax.inject_hyperparams): three steps from the same
parameters and gradients, the learning rate changed between steps 2 and
3; after every step the parameters agree within 1e-6 (updates are about
1e-2), centered RMSprop and the bfloat16 moments (mu_dtype,
accumulator_dtype) included: both packages compute each moment in
float32 and round the same value to bfloat16 to store it, so the
parameters keep the 1e-6 bound, and the stored moments are bfloat16 and
within one bfloat16 ulp of optax's. Also the kwarg translation, Keras' eps
default, and the optax defaults that differ from torch.optim's."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from multiplanarunet_tpu.train.utils import init_optimizer as j_init
from multiplanarunet_tpu_torch.train import optimizers as topt
from multiplanarunet_tpu_torch.train.utils import (
    init_optimizer,
    translate_optimizer_kwargs,
)

torch.set_num_threads(1)

CASES = [
    ("Adam", {"lr": 1e-2, "beta_1": 0.8, "beta_2": 0.99, "epsilon": 1e-8,
              "decay": 0.0}),
    ("Adam", {"lr": 1e-2}),
    ("AdamW", {"lr": 1e-2, "weight_decay": 0.05}),
    ("AdamW", {"lr": 1e-2}),
    ("Nadam", {"lr": 1e-2, "beta_1": 0.85}),
    ("SGD", {"lr": 1e-2}),
    ("SGD", {"lr": 1e-2, "momentum": 0.9, "nesterov": True}),
    ("RMSprop", {"lr": 1e-2}),
    ("RMSprop", {"lr": 1e-2, "rho": 0.8, "momentum": 0.5, "epsilon": 1e-6}),
    ("Adagrad", {"lr": 1e-2}),
    ("Adamax", {"lr": 1e-2, "beta_2": 0.9}),
    ("Lamb", {"lr": 1e-2, "weight_decay": 0.01}),
    ("Lion", {"lr": 1e-2}),
    ("RMSprop", {"lr": 1e-2, "centered": True}),
    ("RMSprop", {"lr": 1e-2, "centered": True, "momentum": 0.5,
                 "nesterov": True}),
    ("RMSprop", {"lr": 1e-2, "centered": True, "bias_correction": True,
                 "eps_in_sqrt": False}),
    ("Adam", {"lr": 1e-2, "mu_dtype": "bfloat16"}),
    ("Nadam", {"lr": 1e-2, "mu_dtype": "bfloat16"}),
    ("AdamW", {"lr": 1e-2, "mu_dtype": "bfloat16"}),
    ("Lion", {"lr": 1e-2, "mu_dtype": "bfloat16"}),
    ("SGD", {"lr": 1e-2, "momentum": 0.9, "accumulator_dtype": "bfloat16"}),
]
# The name of each case's bfloat16 moment in the port's state
BF16_MOMENT = {"mu_dtype": "mu", "accumulator_dtype": "trace"}
SHAPES = [(3, 3, 2, 5), (5,), (7, 4), (1,)]


def _params_and_grads(seed):
    rng = np.random.RandomState(seed)
    params = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    params[3][:] = 0.0  # a zero parameter (Lamb's trust ratio -> 1)
    grads = [[(rng.randn(*s) * 10.0 ** rng.uniform(-4, 1)).astype(np.float32)
              for s in SHAPES] for _ in range(3)]
    grads[1][1][:2] = 0.0  # exact zeros (Adagrad, Lion sign)
    return params, grads


@pytest.mark.parametrize("name,kwargs", CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(CASES)])
def test_optimizer_matches_optax(name, kwargs):
    params, grads = _params_and_grads(0)
    tx = j_init(name, **kwargs)
    jparams = {str(i): jnp.asarray(p) for i, p in enumerate(params)}
    state = tx.init(jparams)
    tparams = [torch.nn.Parameter(torch.from_numpy(p.copy()))
               for p in params]
    opt = init_optimizer(name, tparams, **kwargs)
    for step, g in enumerate(grads):
        if step == 2:
            state.hyperparams["learning_rate"] = jnp.asarray(
                3e-3, dtype=state.hyperparams["learning_rate"].dtype)
            opt.learning_rate = 3e-3
        jg = {str(i): jnp.asarray(x) for i, x in enumerate(g)}
        updates, state = tx.update(jg, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, x in zip(tparams, g):
            p.grad = torch.from_numpy(x.copy())
        opt.step()
        for i, p in enumerate(tparams):
            np.testing.assert_allclose(
                p.detach().numpy(), np.asarray(jparams[str(i)]), rtol=0,
                atol=1e-6, err_msg=f"{name} step {step} param {i}")
    assert opt.learning_rate == float(np.float32(3e-3))
    assert opt.packed.data.dtype == torch.float32
    for key, moment in BF16_MOMENT.items():
        if key not in kwargs:
            continue
        # optax's bfloat16 leaves: the moment of each parameter, by key
        want = [np.asarray(x, np.float32) for x in jax.tree.leaves(state)
                if x.dtype == jnp.bfloat16]
        got = opt.state[moment]
        assert got.dtype == torch.bfloat16 and len(want) == len(SHAPES)
        for off, view, w in zip(opt.packed.offsets, opt.packed.param_views,
                                want):
            g = got[off:off + view.numel()].float().numpy().reshape(w.shape)
            ulp = np.spacing(np.abs(w).astype(np.float32)) * 2.0 ** 16
            assert np.all(np.abs(g - w) <= np.maximum(ulp, 1e-30)), name


@pytest.mark.parametrize("name,kwargs", CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(CASES)])
def test_kwarg_translation_matches_injected_hyperparams(name, kwargs):
    """The translated kwargs are hyperparameters the JAX package injects,
    at the same values (Keras names mapped, unknown ones dropped, eps 1e-7
    for Adam/Nadam/Adamax/RMSprop when the config names none); the other
    injected ones are optax defaults, which the port's optimizer holds
    too."""
    state = j_init(name, **kwargs).init({"a": jnp.zeros(2)})
    want = {k: float(v) for k, v in state.hyperparams.items()}
    got = {k: float(np.float32(v)) for k, v in
           translate_optimizer_kwargs(name, **kwargs).items()
           if not isinstance(v, (bool, str))}  # static, not injected
    assert {k: want[k] for k in got} == got
    opt = init_optimizer(name, [torch.nn.Parameter(torch.zeros(2))],
                         **kwargs)
    for key in set(want) - set(got):
        attr = {"initial_accumulator_value": "initial"}.get(key, key)
        assert float(getattr(opt, attr)) == want[key], key


def test_eps_default_and_named_errors():
    logged = []
    t = translate_optimizer_kwargs("Adam", logger=logged.append,
                                   lr=1e-3, decay=0.0)
    assert t == {"learning_rate": 1e-3, "eps": 1e-7}
    assert any("'decay'" in m for m in logged)
    # the project default names epsilon 1e-8: it is kept
    assert translate_optimizer_kwargs("Adam", lr=1e-3, epsilon=1e-8)[
        "eps"] == 1e-8
    # Keras' learning-rate decay becomes RMSprop's decay, as in the JAX
    # package
    assert translate_optimizer_kwargs("RMSprop", lr=1e-3, decay=0.0)[
        "decay"] == 0.0
    assert "eps" not in translate_optimizer_kwargs("Lamb", lr=1e-3)
    with pytest.raises(ValueError, match="Unknown optimizer"):
        translate_optimizer_kwargs("Adadelta", lr=1e-3)
    p = [torch.nn.Parameter(torch.zeros(3))]
    # a weight-decay mask is a callable or a pytree over flax's parameter
    # tree: a YAML cannot express it, and the port's parameters are a list
    for name in ("AdamW", "Lamb", "Lion"):
        with pytest.raises(topt.UnsupportedOptimizerOptionError,
                           match="YAML"):
            init_optimizer(name, p, lr=1e-3, mask=lambda params: params)
    with pytest.raises(topt.UnsupportedOptimizerOptionError,
                       match="mu_dtype"):
        init_optimizer("Adam", p, lr=1e-3, mu_dtype="int8")


def test_optax_defaults_differ_from_torch_optim():
    """The defaults the port takes from optax, not torch.optim."""
    p = [torch.nn.Parameter(torch.ones(4))]
    assert topt.AdamW(p, 1e-3).weight_decay == np.float32(1e-4)
    assert torch.optim.AdamW([torch.nn.Parameter(torch.ones(1))]).defaults[
        "weight_decay"] == 1e-2
    rms = topt.RMSprop([torch.nn.Parameter(torch.ones(4))], 1e-3)
    assert rms.decay == np.float32(0.9) and rms.eps_in_sqrt
    assert torch.optim.RMSprop([torch.nn.Parameter(torch.ones(1))]).defaults[
        "alpha"] == 0.99
    ada = topt.Adagrad([torch.nn.Parameter(torch.ones(4))], 1e-3)
    assert float(ada.state["sum_of_squares"][0]) == np.float32(0.1)
    assert torch.optim.Adagrad([torch.nn.Parameter(torch.ones(1))]).defaults[
        "initial_accumulator_value"] == 0.0


def test_parameters_are_views_of_one_packed_vector():
    a = torch.nn.Parameter(torch.arange(5.0))
    b = torch.nn.Parameter(torch.ones(3, 2))
    opt = topt.SGD([a, b], 0.5)
    assert a.data_ptr() == opt.packed.data.data_ptr()
    assert (b.data_ptr() - a.data_ptr()) % 256 == 0
    a.grad = torch.ones(5)  # b gets no gradient: it stays
    opt.step()
    np.testing.assert_array_equal(a.detach().numpy(),
                                  np.arange(5.0) - 0.5)
    np.testing.assert_array_equal(b.detach().numpy(), np.ones((3, 2)))
