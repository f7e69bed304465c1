"""The port's VQ-VAE held against the JAX package on the CPU: the codebook
search (indices equal except at near ties), the forward (x_bar, z_e, z_q)
without conditioning, with global and with local conditioning, and with
``decoder_conf.use_pallas_stacks`` (the port's plain version of K6
against JAX's Pallas kernel in interpret mode), the straight-through
gradients against ``jax.grad``, the VQ collater bit for bit, the train
step against JAX's ``build_train_step`` on ``vqvae.v1.debug.yaml`` and
``local_conditioned_melgan_vae.v3.debug.yaml``, the decode (WAVs and the
symbol file ``text``) against JAX's ``_decode_vqvae``, and chip_smoke's
embedded VQ-VAE config against its YAML file.

Near ties: the encoder's outputs of the two packages differ by about
1e-6, which can move a latent's nearest codebook row where two rows are
almost as near. An index may differ only where the two squared distances
agree to 1e-5 relative; the decode is then held given JAX's indices.
"""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_port_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from parallelwavegan_tpu.convert.torch_checkpoint import convert_state_dict  # noqa: E402
from parallelwavegan_tpu.data.collater import Collater as JaxCollater  # noqa: E402
from parallelwavegan_tpu.layers.vq import (  # noqa: E402
    nearest_codebook_indices as jax_nearest,
)
from parallelwavegan_tpu.models import get_model_class as jax_model_class  # noqa: E402
from parallelwavegan_tpu.optimizers import (  # noqa: E402
    build_optimizer_from_config as jax_optimizer_from_config,
)
from parallelwavegan_tpu.train.criterion import build_criterion as jax_criterion  # noqa: E402
from parallelwavegan_tpu.train.state import init_train_state  # noqa: E402
from parallelwavegan_tpu.train.step import build_train_step  # noqa: E402
from parallelwavegan_tpu_torch.bin import decode, train  # noqa: E402
from parallelwavegan_tpu_torch.convert.jax_params import jax_params_to_state_dict  # noqa: E402
from parallelwavegan_tpu_torch.data.collater import Collater  # noqa: E402
from parallelwavegan_tpu_torch.layers.vq import nearest_codebook_indices  # noqa: E402
from parallelwavegan_tpu_torch.models import get_model_class  # noqa: E402
from parallelwavegan_tpu_torch.optimizers import build_optimizer_from_config  # noqa: E402
from parallelwavegan_tpu_torch.train.criterion import build_criterion  # noqa: E402
from parallelwavegan_tpu_torch.train.step import TrainStep, batch_to_device  # noqa: E402
from parallelwavegan_tpu_torch.utils.checkpoint import save_checkpoint  # noqa: E402

yaml = pytest.importorskip("yaml")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 2e-4  # tests/test_torch_parity.py:41
VQ = "VQVAE"
# a VQ-VAE of every part at narrow widths: encoder x8 (4, 2) up to 16
# channels, codebook 16 x 8, decoder 32 channels x8 (stages of 16 and 8)
SMALL = dict(in_channels=1, out_channels=1, num_embeds=16, embed_dim=8,
             encoder_conf=dict(out_channels=8, downsample_scales=[4, 2], channels=4,
                               max_downsample_channels=16),
             decoder_conf=dict(in_channels=8, upsample_scales=[4, 2], channels=32,
                               stacks=2))
GLOBAL = dict(num_global_embeds=5, global_embed_dim=6)
LOCAL = dict(num_local_embeds=3, local_embed_dim=4)


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def _load_yaml(rel: str) -> dict:
    with open(os.path.join(ROOT, rel)) as f:
        return yaml.safe_load(f)


def _small(local=False, glob=False, **decoder) -> dict:
    gp = json.loads(json.dumps(SMALL))
    gp["decoder_conf"]["in_channels"] = 8 + 4 * local + 6 * glob
    gp["decoder_conf"].update(decoder)
    return dict(gp, **(LOCAL if local else {}), **(GLOBAL if glob else {}))


def _inputs(rs, b, frames, local, glob):
    x = (0.5 * rs.randn(b, frames * 8, 1)).astype(np.float32)
    l = rs.randn(b, frames, 3).astype(np.float32) if local else None
    g = rs.randint(0, 5, b).astype(np.int32) if glob else None
    return x, l, g


def _port_from_jax(gp, variables):
    model = get_model_class(VQ)(**gp)
    model.load_state_dict(jax_params_to_state_dict(VQ, gp, variables))
    return model


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _ntc(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(np.swapaxes(a, 1, 2)))


def _indices_agree(got, want, z_e, codebook) -> None:
    """Equal indices, or a near tie: the squared distances of the latent to
    the two rows agree to 1e-5 relative."""
    got, want = np.asarray(got).reshape(-1), np.asarray(want).reshape(-1)
    z = np.asarray(z_e, np.float64).reshape(len(want), -1)
    cb = np.asarray(codebook, np.float64)
    for i in np.flatnonzero(got != want):
        d_got = np.sum((z[i] - cb[got[i]]) ** 2)
        d_want = np.sum((z[i] - cb[want[i]]) ** 2)
        assert abs(d_got - d_want) <= 1e-5 * max(d_want, 1e-30), (i, d_got, d_want)


def test_nearest_codebook_indices_match_jax_and_ties_take_the_first_row():
    rs = np.random.RandomState(0)
    z = rs.randn(4, 50, 16).astype(np.float32)
    cb = rs.randn(64, 16).astype(np.float32)
    cb[9] = cb[3]  # an exact tie: both packages take row 3
    z[0, 0] = cb[3]
    got = nearest_codebook_indices(torch.from_numpy(z), torch.from_numpy(cb)).numpy()
    want = np.asarray(jax_nearest(jnp.asarray(z), jnp.asarray(cb)))
    assert got.shape == want.shape == (4, 50) and got[0, 0] == want[0, 0] == 3
    assert 9 not in got and 9 not in want
    _indices_agree(got, want, z, cb)
    # the first index on an exact tie, where the rows' order decides
    assert int(nearest_codebook_indices(torch.zeros(1, 2), torch.ones(3, 2))[0]) == 0


@pytest.mark.parametrize("local,glob", [(False, False), (False, True), (True, True)])
def test_forward_matches_jax(local, glob):
    """(x_bar, z_e, z_q) within 2e-4 from the same weights; with local
    features (B, T', 3) embedded to 4 and global ids of 5 embedded to 6."""
    gp = _small(local, glob)
    x, l, g = _inputs(np.random.RandomState(1), 2, 12, local, glob)
    jm = jax_model_class(VQ)(**gp)
    args = [jnp.asarray(x), None if l is None else jnp.asarray(l),
            None if g is None else jnp.asarray(g)]
    variables = jm.init(jax.random.key(0), *args)
    want = [np.asarray(a) for a in jm.apply(variables, *args)]
    model = _port_from_jax(gp, variables)
    x_bar, z_e, z_q = model(_ntc(x), _ntc(l), _t(g))
    np.testing.assert_allclose(z_e.detach().numpy(), want[1], atol=TOL, rtol=0)
    cb = np.asarray(variables["params"]["codebook"]["embedding"])
    idx = model.encode(_ntc(x)).numpy()
    jidx = np.asarray(jm.apply(variables, args[0], method="encode"))
    _indices_agree(idx, jidx, want[1], cb)
    if (idx == jidx).all():
        np.testing.assert_allclose(x_bar.detach().numpy().transpose(0, 2, 1), want[0],
                                   atol=TOL, rtol=0)
        np.testing.assert_allclose(z_q.detach().numpy(), want[2], atol=TOL, rtol=0)
    got = model.decode(_t(jidx).long(), _ntc(l), _t(g)).detach().numpy()
    np.testing.assert_allclose(got.transpose(0, 2, 1), want[0], atol=TOL, rtol=0)
    assert x_bar.shape == (2, 1, 96) and z_e.shape == z_q.shape == (2, 12, 8)


def test_forward_with_use_pallas_stacks_matches_jax_interpret(monkeypatch):
    """``decoder_conf.use_pallas_stacks`` reaches the MelGAN stack kernel
    in both packages (JAX's Pallas kernel forced in interpret mode, the
    port's K6 wrapper on its plain version): both decoder stages (16 and 8
    channels, the last with the final conv) go through it."""
    import parallelwavegan_tpu_torch.models.melgan as melgan_mod

    seen, real = [], melgan_mod.fused_melgan_stacks

    def spy(x, *args, **kwargs):
        seen.append(x.shape[-1])
        return real(x, *args, **kwargs)

    monkeypatch.setattr(melgan_mod, "fused_melgan_stacks", spy)
    monkeypatch.setenv("PALLAS_INTERPRET_OK", "1")
    gp = _small(glob=True, use_pallas_stacks=True)
    x, _, g = _inputs(np.random.RandomState(2), 2, 8, False, True)
    jm = jax_model_class(VQ)(**gp)
    variables = jm.init(jax.random.key(1), jnp.asarray(x), None, jnp.asarray(g))
    want = jm.apply(variables, jnp.asarray(x), None, jnp.asarray(g))
    model = _port_from_jax(gp, variables)
    with torch.no_grad():  # the kernel is inference-only, as JAX's
        x_bar, z_e, _ = model(_ntc(x), None, _t(g))
    assert seen == [16, 8]
    idx = model.encode(_ntc(x)).numpy()
    jidx = np.asarray(jm.apply(variables, jnp.asarray(x), method="encode"))
    _indices_agree(idx, jidx, np.asarray(want[1]),
                   np.asarray(variables["params"]["codebook"]["embedding"]))
    with torch.no_grad():
        got = model.decode(_t(jidx).long(), None, _t(g))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 1), np.asarray(want[0]),
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(z_e.numpy(), np.asarray(want[1]), atol=TOL, rtol=0)


def test_straight_through_gradients_match_jax_grad():
    """The gradients of mean(x_bar r) + q + 0.25 c (r a unit random
    cotangent; q the quantization loss mean((z_q - sg(z_e))^2), c the
    commitment loss mean((z_e - sg(z_q))^2)) with respect to every
    parameter, each within 1e-4 of its leaf's largest: the codebook's
    reach it only through q, the encoder's through the decoder's straight
    path and c. Swapping the two stop-gradients gives the same loss and
    other gradients, which the check rejects."""
    gp = _small(glob=True)
    x, _, g = _inputs(np.random.RandomState(3), 2, 12, False, True)
    r = np.random.RandomState(4).randn(2, 96, 1).astype(np.float32)
    jm = jax_model_class(VQ)(**gp)
    variables = jm.init(jax.random.key(2), jnp.asarray(x), None, jnp.asarray(g))

    def jloss(params):
        x_bar, z_e, z_q = jm.apply({"params": params}, jnp.asarray(x), None, jnp.asarray(g))
        q = jnp.mean((z_q - jax.lax.stop_gradient(z_e)) ** 2)
        c = jnp.mean((z_e - jax.lax.stop_gradient(z_q)) ** 2)
        return jnp.mean(x_bar * r) + q + 0.25 * c

    jgrads = jax_params_to_state_dict(VQ, gp, jax.jit(jax.grad(jloss))(variables["params"]))

    def port_grads(swap):
        model = _port_from_jax(gp, variables)
        x_bar, z_e, z_q = model(_ntc(x), None, _t(g))
        a, b = (z_e, z_q) if swap else (z_q, z_e)
        q = torch.mean((a - b.detach()) ** 2)
        c = torch.mean((b - a.detach()) ** 2)
        loss = torch.mean(x_bar.transpose(1, 2) * torch.from_numpy(r)) + q + 0.25 * c
        loss.backward()
        return {k: p.grad for k, p in model.named_parameters()}

    def worst(grads):
        assert sorted(grads) == sorted(jgrads)
        return max(float((grads[k] - v).abs().max() / v.abs().max().clamp_min(1e-30))
                   for k, v in jgrads.items())

    assert worst(port_grads(False)) <= 1e-4
    assert float(jgrads["codebook.embedding.weight"].abs().max()) > 0
    assert worst(port_grads(True)) > 1e-2


def test_vq_input_pqmf_analysis_matches_jax():
    """A VQ-VAE whose encoder reads sub-bands (``in_channels`` 4): the train
    step's encoder input is the PQMF analysis of the wave with the config's
    ``pqmf_params``, as JAX's ``_with_vq_input`` makes it; a one-channel
    encoder reads the wave itself."""
    from parallelwavegan_tpu.train.step import _with_vq_input
    from parallelwavegan_tpu_torch.train.step import vq_input

    y = (0.3 * np.random.RandomState(12).randn(2, 512, 1)).astype(np.float32)
    for in_channels in (4, 1):
        config = {"generator_type": VQ, "pqmf_params": {"taps": 62, "cutoff_ratio": 0.142},
                  "generator_params": {"in_channels": in_channels, "out_channels": 1}}
        want = np.asarray(_with_vq_input({"y": jnp.asarray(y)}, config,
                                         jax_criterion(dict(config)))["y_in"])
        crit = build_criterion(dict(config))
        assert crit.pqmf is None
        got = vq_input(crit, batch_to_device({"y": y}, "cpu"))["y_in"].numpy()
        np.testing.assert_allclose(got.transpose(0, 2, 1), want, atol=1e-6, rtol=0)
        assert want.shape == (2, 512 // in_channels, in_channels)


def _vq_items(rs, n, samples, local=False, glob=False, hop=8):
    items = []
    for i in range(n):
        audio = (0.3 * rs.randn(samples + 37 * i)).astype(np.float32)
        if local:  # the features' frames cover the wave
            audio = audio[:len(audio) // hop * hop]
        item = [audio]
        if local:
            item.append(rs.randn(len(audio) // hop, 2).astype(np.float32))
        if glob:
            item.append(np.array([rs.randint(10)]))
        items.append(tuple(item) if len(item) > 1 else audio)
    return items


@pytest.mark.parametrize("local,glob", [(False, False), (False, True), (True, False),
                                        (True, True)])
def test_vq_collater_matches_jax_bit_for_bit(local, glob):
    """The wave-to-wave crops (and the hop-grid local crops) of three
    items over two batches from the same seed, hop None without local
    features as a wave-to-wave config has."""
    hop = 8 if local else None
    items = _vq_items(np.random.RandomState(5), 3, 600, local, glob)
    kw = dict(batch_max_steps=256, hop_size=hop, aux_context_window=0,
              use_aux_input=False, use_local_condition=local, use_global_condition=glob)
    port, jaxc = (C(**kw, rng=np.random.default_rng(6)) for C in (Collater, JaxCollater))
    for _ in range(2):
        got, want = port(items), jaxc(items)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    assert ("local" in got) == local and ("global" in got) == glob




def _run_steps(config, batches, phases):
    """The port's and JAX's train steps on the same batches from the same
    weights (the port's init carried into JAX, copied: JAX reads numpy
    arrays in place and runs behind the host, while the port's optimizer
    updates its parameters in place); every loss to 1e-5 relative at every
    step, every parameter of G and D to 1e-5 after."""
    gp, dp = config["generator_params"], config["discriminator_params"]
    dis_type = config["discriminator_type"]
    init = torch.Generator().manual_seed(0)
    gen = get_model_class(VQ)(**gp, generator=init)
    dis = get_model_class(dis_type)(**dp, generator=init)
    jcfg = json.loads(json.dumps(config))
    params_g, params_d = (convert_state_dict(t, p, {
        k: v.numpy().copy() for k, v in m.state_dict().items()})[0]
        for t, p, m in ((VQ, gp, gen), (dis_type, dp, dis)))
    opt_g = build_optimizer_from_config(config, "generator", gen.parameters())
    opt_d = build_optimizer_from_config(config, "discriminator", dis.parameters())
    step = TrainStep(config, gen, dis, build_criterion(config), opt_g, opt_d)
    tx_g, tx_d = (jax_optimizer_from_config(jcfg, w) for w in ("generator", "discriminator"))
    state = init_train_state(params_g, params_d, tx_g, tx_d)
    jg, jd = jax_model_class(VQ)(**gp), jax_model_class(dis_type)(**dp)
    steps = {p: build_train_step(jcfg, jg, jd, jax_criterion(jcfg), tx_g, tx_d,
                                 train_g=p[0], train_d=p[1], donate=False)
             for p in set(phases)}
    for i, (batch, phase) in enumerate(zip(batches, phases)):
        state, want = steps[phase](state, {k: jnp.asarray(v) for k, v in batch.items()},
                                   jax.random.key(i))
        got = step(batch_to_device(batch, "cpu"), *phase, step=i)
        assert sorted(got) == sorted(want), i
        for k in want:
            rel = abs(float(got[k]) - float(want[k])) / abs(float(want[k]))
            assert rel <= 1e-5, (i, k, float(got[k]), float(want[k]))
    for name, tree, model, mtype, mp in (("G", state.params_g, gen, VQ, gp),
                                         ("D", state.params_d, dis, dis_type, dp)):
        have = jax_params_to_state_dict(mtype, mp, jax.tree_util.tree_map(np.asarray, tree))
        sd = model.state_dict()
        assert sorted(have) == sorted(sd), name
        for k, v in have.items():
            err = float((sd[k] - v).abs().max())
            assert err <= 1e-5, (name, k, err)
    return got


@pytest.mark.parametrize("rel,local", [
    ("egs/yesno/vq1/conf/vqvae.v1.debug.yaml", False),
    ("egs/yesno/vq1/conf/local_conditioned_melgan_vae.v3.debug.yaml", True),
])
def test_train_step_matches_jax_build_train_step(rel, local):
    """4 steps (2 G-only, as the configs' D start gives, then 2 G+D) of the
    recipe configs as they ship on collated crops: the quantization,
    commitment, STFT, adversarial and feature-matching losses and every
    parameter; the local-conditioned v3 (speakers and 2 local features at
    hop 64, the decoder's 416-channel input) at its full widths."""
    config = _load_yaml(rel)
    hop = config.get("hop_size")
    glob = config.get("use_global_condition", False)
    kw = dict(batch_max_steps=config["batch_max_steps"], hop_size=hop,
              aux_context_window=0, use_aux_input=False, use_local_condition=local,
              use_global_condition=glob, rng=np.random.default_rng(7))
    collater = Collater(**kw)
    items = _vq_items(np.random.RandomState(8), config["batch_size"],
                      config["batch_max_steps"] + 600, local, glob, hop=hop or 1)
    if glob:  # the recipe's 128 speakers
        items = [(it[0], *it[1:-1], np.array([i * 37 % 128])) for i, it in enumerate(items)]
    batches = [collater(items) for _ in range(4)]
    phases = [(True, False)] * 2 + [(True, True)] * 2
    got = _run_steps(config, batches, phases)
    assert {"quantization_loss", "commitment_loss", "feature_matching_loss",
            "real_loss"} <= set(got)


def _write_vq_dump(root, n, local, glob, hop, seed=9):
    rs = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        audio = (0.3 * rs.randn(700 + 300 * i)).astype(np.float32)
        np.save(os.path.join(root, f"u{i}-wave.npy"), audio)
        if local:
            np.save(os.path.join(root, f"u{i}-local.npy"),
                    rs.randn(len(audio) // hop, 3).astype(np.float32))
        if glob:
            np.save(os.path.join(root, f"u{i}-global.npy"), np.array([rs.randint(5)]))


def _write_vq_scp(root, seed=11):
    """Two 16-bit recordings of 1200 and 900 samples, their wav.scp and a
    kaldi segments file of three utterances (the last to the recording's
    end, -1)."""
    from parallelwavegan_tpu_torch.utils.io import write_wav

    rs = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "wav.scp"), "w") as f:
        for r, n in (("r0", 1200), ("r1", 900)):
            path = os.path.join(root, f"{r}.wav")
            write_wav(path, 8000, 0.3 * rs.randn(n))
            f.write(f"{r} {path}\n")
    with open(os.path.join(root, "segments"), "w") as f:
        f.write("u0 r0 0.0 0.0875\nu1 r0 0.05 0.15\nu2 r1 0.0 -1\n")
    return ["--feats-scp", os.path.join(root, "wav.scp"), "--segments",
            os.path.join(root, "segments")]


@pytest.mark.parametrize("local,glob,scp", [(False, False, False), (True, True, False),
                                            (False, False, True)])
def test_decode_matches_jax_decode_vqvae(tmp_path, monkeypatch, local, glob, scp):
    """``bin/decode.main`` against JAX's ``_decode_vqvae`` from the same
    weights, on a tiny npy dump (utterances of 700, 1000 and 1300 samples,
    not multiples of the 128-sample bucket) or on a wav.scp with a segments
    file (``--feats-scp --segments``): each WAV within 2e-4 (16-bit files,
    so within a step of 1/32768 beyond it) and the symbol file ``text``
    with JAX's ids (equal except at near ties of the latent, which the
    port's encoder gives on the padded wave as decode pads it)."""
    from flax import serialization

    from parallelwavegan_tpu.bin import decode as jax_decode
    from parallelwavegan_tpu_torch.data.datasets import AudioDataset, AudioSCPDataset

    gp = _small(local, glob)
    config = {"sampling_rate": 8000, "format": "npy", "generator_type": VQ,
              "generator_params": gp, "use_local_condition": local,
              "use_global_condition": glob}
    if local:
        config["hop_size"] = 8
    if scp:
        inputs = _write_vq_scp(str(tmp_path / "scp"))
        dataset = AudioSCPDataset(inputs[1], segments=inputs[3], return_utt_id=True)
    else:
        _write_vq_dump(str(tmp_path / "dump"), 3, local, glob, 8)
        inputs = ["--dumpdir", str(tmp_path / "dump")]
        dataset = AudioDataset(str(tmp_path / "dump"), audio_query="*-wave.npy",
                               audio_load_fn=np.load, return_utt_id=True)
    audio = {item[0]: item[1] for item in (dataset[i] for i in range(len(dataset)))}
    gen = get_model_class(VQ)(**gp, generator=torch.Generator().manual_seed(3))
    exp = tmp_path / "exp"
    save_checkpoint(str(exp / "checkpoint-1steps.pkl"), gen.state_dict(), steps=1)
    params = convert_state_dict(VQ, gp, {k: v.numpy().copy()
                                         for k, v in gen.state_dict().items()})[0]
    with open(tmp_path / "jax.msgpack", "wb") as f:
        f.write(serialization.to_bytes({"steps": np.asarray(1), "model": {
            "generator": jax.tree_util.tree_map(np.asarray, params)},
            "vars": {"generator": {}}}))
    with open(tmp_path / "c.yml", "w") as f:
        yaml.safe_dump(config, f)
    decode.main(inputs + ["--outdir", str(tmp_path / "port"), "--checkpoint",
                          str(exp / "checkpoint-1steps.pkl"), "--config",
                          str(tmp_path / "c.yml"), "--device", "cpu", "--verbose", "0"])
    monkeypatch.setattr(sys, "argv", ["decode"] + inputs + [
        "--outdir", str(tmp_path / "jax"), "--checkpoint", str(tmp_path / "jax.msgpack"),
        "--config", str(tmp_path / "c.yml"), "--no-compilation-cache", "--verbose", "0"])
    jax_decode.main()
    from scipy.io import wavfile

    assert len(audio) == 3
    for utt, x in audio.items():
        _, a = wavfile.read(tmp_path / "port" / f"{utt}_gen.wav")
        _, b = wavfile.read(tmp_path / "jax" / f"{utt}_gen.wav")
        assert a.shape == b.shape == x.shape
        assert np.abs(a.astype(np.int64) - b).max() <= TOL * 32768 + 1
    lines = [(tmp_path / d / "text").read_text().splitlines() for d in ("port", "jax")]
    assert len(lines[0]) == len(lines[1]) == 3
    cb = gen.codebook.embedding.weight.detach().numpy()
    for got, want in zip(*lines):
        (utt, *g_ids), (utt2, *w_ids) = got.split(), want.split()
        t = len(audio[utt])
        assert utt == utt2 and len(g_ids) == len(w_ids) == -(-t // 8)
        padded = np.pad(audio[utt], (0, -(-t // 128) * 128 - t), mode="edge")
        with torch.no_grad():
            z_e = gen._encode_latent(torch.from_numpy(padded[None, None]))[0].numpy()
        _indices_agree(np.array(g_ids, int), np.array(w_ids, int), z_e[:len(w_ids)], cb)


@pytest.mark.parametrize("rel,steps", [
    ("egs/yesno/vq1/conf/vqvae.v1.debug.yaml", 4),
    ("egs/yesno/vq1/conf/local_conditioned_melgan_vae.v3.debug.yaml", 2),
])
def test_train_main_then_decode_on_a_dump(tmp_path, rel, steps):
    """``bin/train.main`` on a yesno VQ recipe config as it ships but for its
    loop (``steps`` steps, D from step 3 or 2, an eval and a checkpoint at
    the last) on an npy dump (``*-wave.npy``, and for the conditioned v3
    ``*-local.npy`` on the hop-64 grid and ``*-global.npy``), then
    ``bin/decode.main`` of the checkpoint: every WAV of its utterance's
    length and the symbol file's ids in the codebook."""
    config = dict(_load_yaml(rel), format="npy", train_max_steps=steps,
                  discriminator_train_start_steps=steps - 2, save_interval_steps=steps,
                  eval_interval_steps=steps, log_interval_steps=1)
    gp = config["generator_params"]
    local, glob = config.get("use_local_condition"), config.get("use_global_condition")
    for split, seed in (("train", 0), ("dev", 1)):
        rs = np.random.RandomState(seed)
        os.makedirs(tmp_path / split)
        for i in range(2):
            n = 4224 + 512 * i
            np.save(tmp_path / split / f"u{i}-wave.npy",
                    (0.3 * rs.randn(n)).astype(np.float32))
            if local:
                np.save(tmp_path / split / f"u{i}-local.npy",
                        rs.randn(n // config["hop_size"], gp["num_local_embeds"]
                                 ).astype(np.float32))
            if glob:
                np.save(tmp_path / split / f"u{i}-global.npy",
                        np.array([rs.randint(gp["num_global_embeds"])]))
    with open(tmp_path / "c.json", "w") as f:
        json.dump(config, f)
    out = train.main(["--train-dumpdir", str(tmp_path / "train"), "--dev-dumpdir",
                      str(tmp_path / "dev"), "--outdir", str(tmp_path / "exp"), "--config",
                      str(tmp_path / "c.json"), "--device", "cpu", "--verbose", "0"])
    assert out["steps"] == steps
    logged = {}
    for s, m in out["history"]:
        logged.setdefault(s, {}).update(m)
    assert "train/quantization_loss" in logged[1] and "train/real_loss" in logged[steps]
    assert "eval/commitment_loss" in logged[steps]
    decode.main(["--dumpdir", str(tmp_path / "dev"), "--outdir", str(tmp_path / "wav"),
                 "--checkpoint", str(tmp_path / "exp" / f"checkpoint-{steps}steps.pkl"),
                 "--device", "cpu", "--verbose", "0"])
    from scipy.io import wavfile

    for i in range(2):
        _, wav = wavfile.read(tmp_path / "wav" / f"u{i}-wave_gen.wav")
        assert wav.shape == (4224 + 512 * i,) and np.abs(wav).max() > 0
    for line in (tmp_path / "wav" / "text").read_text().splitlines():
        ids = [int(v) for v in line.split()[1:]]
        assert ids and all(0 <= v < gp["num_embeds"] for v in ids)


def test_chip_smoke_vq_config_equals_shipped_config():
    """The VQ-VAE config of chip_smoke.py's phase 36 is the YAML verbatim."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)  # defines constants only; main() not run
    assert json.loads(json.dumps(smoke.VQ_VCTK_CONFIG)) == _load_yaml(
        "egs/vctk/vq1/conf/conditioned_melgan_vae.v3.yaml")
