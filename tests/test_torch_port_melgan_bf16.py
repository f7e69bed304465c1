"""The bf16-resident modes of the MelGAN stack kernels K6 and K7 on the
CPU: their plain versions (``melgan_stacks_reference_bf16``,
``melgan_stacks_backward_reference_bf16``) held against the JAX package's
``fused_melgan_stacks`` / ``fused_melgan_stacks_train`` with a bf16 input
in interpret mode (``mxu_bf16``), at the shapes of
tests/test_melgan_stack_train_kernel.py:168-209 (C 64, B 2, T 256, three
stacks at dilations 1, 3, 9, reflect), without and with the final conv.

Both sides round the same operands to bf16 and sum exact products in
float32, so they agree far inside that test's bf16-against-float32 bounds
(2e-2 on the value, 6e-2 on the gradients): rms|diff| <= 5e-4 rms|JAX| and
max|diff| <= 4e-3 max|JAX| (one bf16 step at the largest element), where
the port's float32 plain version, on the same bf16 input, must fail.

JAX recomputes its first and last R outputs (R, the receptive radius, 13
here; 16 with the final conv) with its XLA twin in bf16, which rounds
other values than the kernel; the port pads inside its kernels. So the
values are compared on [R, T - R), and the gradients under a cotangent
that is zero on the first and last R rows: the stitched edges then carry
no gradient in JAX, and the core rows' cones never reach the padding in
either package, so both compute the same function.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_port_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from parallelwavegan_tpu.ops.pallas_kernels.melgan_stack import (  # noqa: E402
    fused_melgan_stacks,
)
from parallelwavegan_tpu.ops.pallas_kernels.melgan_stack_train import (  # noqa: E402
    fused_melgan_stacks_train,
)
from parallelwavegan_tpu_torch.ops.kernels import melgan_stack as k6  # noqa: E402
from parallelwavegan_tpu_torch.ops.kernels import melgan_stack_train as k7  # noqa: E402

C, B, T = 64, 2, 256
KEYS = k7.STACK_KEYS


def _close(got, want) -> bool:
    d, w = np.asarray(got, np.float32) - np.asarray(want, np.float32), np.asarray(want,
                                                                                 np.float32)
    return (float(np.sqrt((d ** 2).mean())) <= 5e-4 * float(np.sqrt((w ** 2).mean()))
            and float(np.abs(d).max()) <= 4e-3 * float(np.abs(w).max()))


def _case(with_final: bool):
    """(x, stacks, final) as numpy arrays: tests/test_melgan_stack_train_kernel.py's
    _rand_stacks (scale 0.1, biases 0.05) and x of scale 0.5."""
    rs = np.random.RandomState(7)

    def w(k, cin, cout):
        return (rs.randn(k, cin, cout) * 0.1).astype(np.float32)

    stacks = [{"wd": w(3, C, C), "bd": (rs.randn(C) * 0.05).astype(np.float32),
               "w1": w(1, C, C), "b1": (rs.randn(C) * 0.05).astype(np.float32),
               "ws": w(1, C, C), "bs": (rs.randn(C) * 0.05).astype(np.float32),
               "dilation": 3 ** j} for j in range(3)]
    final = (w(7, C, 1), (rs.randn(1) * 0.05).astype(np.float32)) if with_final else None
    x = (rs.randn(B, T, C) * 0.5).astype(np.float32)
    return x, stacks, final


def _jax(stacks, final):
    st = [{k: (jnp.asarray(v) if k != "dilation" else v) for k, v in s.items()}
          for s in stacks]
    return st, None if final is None else tuple(jnp.asarray(v) for v in final)


def _torch(stacks, final):
    st = [{k: (torch.from_numpy(v) if k != "dilation" else v) for k, v in s.items()}
          for s in stacks]
    return st, None if final is None else tuple(torch.from_numpy(v) for v in final)


@pytest.mark.parametrize("with_final", [False, True])
def test_bf16_forward_matches_jax_interpret(with_final):
    x, stacks, final = _case(with_final)
    js, jf = _jax(stacks, final)
    want = np.asarray(fused_melgan_stacks(
        jnp.asarray(x).astype(jnp.bfloat16), js, final=jf, pad_mode="reflect", t_tile=32,
        interpret=True).astype(jnp.float32))
    ts, tf = _torch(stacks, final)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = k6.fused_melgan_stacks(xb, ts, final=tf)  # the CPU path: the plain version
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    f32 = k6.fused_melgan_stacks(xb.float(), ts, final=tf)
    r = 13 + (3 if with_final else 0)  # the receptive radius
    core = slice(r, T - r)
    assert _close(got.float().numpy()[:, core], want[:, core])
    assert not _close(f32.numpy()[:, core], want[:, core])


@pytest.mark.parametrize("with_final", [False, True])
def test_bf16_backward_matches_jax_interpret(with_final):
    x, stacks, final = _case(with_final)
    r = 13 + (3 if with_final else 0)
    u = np.random.RandomState(8).randn(B, T, 1 if with_final else C).astype(np.float32)
    u[:, :r] = u[:, T - r:] = 0.0
    js, jf = _jax(stacks, final)

    def f(xx, ws):
        sts = [dict(st, **w) for st, w in zip(js, ws["stacks"])]
        return fused_melgan_stacks_train(xx, sts, final=ws["final"], pad_mode="reflect",
                                         t_tile=32, interpret=True)

    ws = {"stacks": [{k: st[k] for k in KEYS} for st in js], "final": jf}
    _, vjp = jax.vjp(f, jnp.asarray(x).astype(jnp.bfloat16), ws)
    dx_j, dw_j = vjp(jnp.asarray(u).astype(jnp.bfloat16))
    want = [("dx", np.asarray(dx_j.astype(jnp.float32)))]
    for i, d in enumerate(dw_j["stacks"]):
        want += [(f"stacks[{i}].{k}", np.asarray(d[k])) for k in KEYS]
    if with_final:
        want += [("final w", np.asarray(dw_j["final"][0])),
                 ("final b", np.asarray(dw_j["final"][1]))]

    ts, tf = _torch(stacks, final)
    xb, ub = torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(u).to(torch.bfloat16)

    def port(fn, xx, cot):
        dx, dst, dfin = fn(xx, ts, tf, 0.2, "reflect", cot)
        out = [("dx", dx.float().numpy())]
        for i, d in enumerate(dst):
            out += [(f"stacks[{i}].{k}", d[k].numpy()) for k in KEYS]
        return out + ([("final w", dfin[0].numpy()), ("final b", dfin[1].numpy())]
                      if with_final else [])

    got = port(k7.melgan_stacks_backward, xb, ub)  # the CPU path: the plain version
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, g), (_, w) in zip(got, want):
        assert g.shape == w.shape and _close(g, w), name
    f32 = port(k7.melgan_stacks_backward_reference, xb.float(), ub.float())
    assert not all(_close(g, w) for (_, g), (_, w) in zip(f32, want))
