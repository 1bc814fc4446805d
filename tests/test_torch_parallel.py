"""The port's parallelism against the JAX package on the CPU: the row
padding and rank-row helpers, the frame-sharded decode (``parallel/sp.py``) and the sharded vocoder
(``vocoders/streaming.py::vocode_sharded``), the per-rank batches of the
three input pipelines, and the refusals of what M6b will bring.

JAX's multi-process helpers read ``jax.process_index()`` and the mesh's
devices; a stand-in mesh whose devices carry a process index, and a patched
``jax.process_index``, give each rank's view without a cluster. The
frame-sharded JAX decode runs on two of the 8 CPU devices that
``tests/conftest.py`` provides.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from promptttspp_tpu.parallel import distributed as jdist
from promptttspp_tpu.parallel import mesh as jmesh
from promptttspp_tpu.parallel import sp as jsp
from promptttspp_tpu.vocoders import streaming as jax_streaming
from promptttspp_tpu.vocoders.bigvgan_f0 import F0AwareBigVGAN as JaxF0Voc
from promptttspp_tpu_torch import flagship
from promptttspp_tpu_torch.bin import conf
from promptttspp_tpu_torch.data.collate import PromptTTSCollator
from promptttspp_tpu_torch.data.dataset import AllWithSpkPromptNormDataset
from promptttspp_tpu_torch.data.prefetch import (
    _collate_native, entry_metas, finish, prefetch_batches)
from promptttspp_tpu_torch.infer import Synthesizer
from promptttspp_tpu_torch.models.bert import WordPieceTokenizer
from promptttspp_tpu_torch.models.diffusion import DiffNet, GaussianDiffusion
from promptttspp_tpu_torch.parallel import (
    host_batches, make_mesh, mesh_process_rows, pad_batch_to_multiple,
    pad_batch_to_rows, process_slice)
from promptttspp_tpu_torch.parallel.sp import (
    FrameShardedDenoiser, decode_frames_sharded, receptive_radius)
from promptttspp_tpu_torch.train.trainer import MODEL_BATCH_KEYS
from promptttspp_tpu_torch.compat.from_jax import load_jax_variables
from promptttspp_tpu_torch.vocoders import streaming
from promptttspp_tpu_torch.vocoders.bigvgan_f0 import F0AwareBigVGAN
from tests.test_torch_acoustic import TOL
from tests.test_torch_cuda import (
    C, MEL, TINY_BERT, tiny_model_config, train_batch)
from tests.test_torch_ddp import corpus  # noqa: F401 (fixture)
from tests.test_torch_decode import twins as decoder_twins
from tests.test_torch_streaming import HALO, MARGIN, SMALL, UP, _vibrato
from tests.test_torch_streaming import TOL as VOC_TOL
from tests.test_torch_synth import (
    MEAN, PROMPTS, SEQS, STD, UPSAMPLE, VOC_KW, WordIdTokenizer)

# the frame-sharded decode against the unsharded one: the same draws and
# the same convolutions over other lengths, which may sum in another order
SHARDED_ATOL = 1e-5


def _equal_batches(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k


# ----------------------------------------------------------- helpers
@pytest.mark.parametrize("weights", [None, (1.0, 0.0, 1.0)])
@pytest.mark.parametrize("rows", [3, 5, 8])
def test_pad_batch_to_rows_matches_jax(rows, weights):
    batch = train_batch(seed=rows)
    if weights is None:
        del batch["batch_weight"]
    _equal_batches(pad_batch_to_rows(dict(batch), rows),
                   jmesh.pad_batch_to_rows(dict(batch), rows))
    for multiple in (1, 2, 4):
        _equal_batches(pad_batch_to_multiple(dict(batch), multiple),
                       jmesh.pad_batch_to_multiple(dict(batch), multiple))
    with pytest.raises(ValueError):
        pad_batch_to_rows(batch, 2)


def _fake_mesh(world):
    """A data axis of ``world`` devices, one per process."""
    devices = np.empty((world, 1), object)
    for p in range(world):
        devices[p, 0] = types.SimpleNamespace(process_index=p)
    return types.SimpleNamespace(shape={"data": world, "model": 1},
                                 devices=devices)


@pytest.mark.parametrize("n_rows,world,multiple", [
    (6, 2, None), (5, 2, None), (1, 2, None), (3, 4, None), (7, 4, None),
    (5, 2, 4), (9, 3, 6)])
def test_rank_rows_match_jax(monkeypatch, n_rows, world, multiple):
    """``mesh_process_rows`` for every rank against JAX's, ragged and
    all-padding slabs included; ``process_slice`` where the rows divide."""
    for rank in range(world):
        monkeypatch.setattr(jax, "process_index", lambda r=rank: r)
        assert mesh_process_rows(n_rows, rank, world, multiple) == \
            jdist.mesh_process_rows(_fake_mesh(world), n_rows, multiple)
        if n_rows % world == 0:
            assert process_slice(n_rows, rank, world) == \
                jdist.process_slice(n_rows, rank, world)
    with pytest.raises(ValueError):
        process_slice(5, 0, 2)
    with pytest.raises(ValueError):
        mesh_process_rows(4, 0, 2, 3)


class _Lengths:
    """A dataset's metadata: frames and phones per item."""

    def __init__(self, seed=0, n=20):
        rng = np.random.RandomState(seed)
        self.frames = rng.randint(10, 300, n)
        self.phones = rng.randint(3, 60, n)

    def num_tokens(self, i):
        return int(self.frames[i])

    def num_phones(self, i):
        return int(self.phones[i])


@pytest.mark.parametrize("world", [2, 3])
def test_host_batches_match_jax(monkeypatch, world):
    """Every rank's rows and collate keywords against JAX's
    ``host_batches`` on a mesh; the port adds the global batch's indices
    (``_global``)."""
    ds = _Lengths()
    sampler = [[3, 1, 4, 15, 9], [2, 6], [5], [0, 7, 8, 10, 11, 12]]
    jcoll = types.SimpleNamespace(frame_quantum=64, phone_quantum=16)
    for rank in range(world):
        monkeypatch.setattr(jax, "process_index", lambda r=rank: r)
        ours = list(host_batches(sampler, ds, rank=rank, world=world))
        ref = list(jdist.host_batches(sampler, ds, jcoll,
                                      process_count=world,
                                      mesh=_fake_mesh(world),
                                      row_multiple=world))
        assert len(ours) == len(ref)
        for (idx, kw), (jidx, jkw), glob in zip(ours, ref, sampler):
            assert idx == jidx
            assert kw.pop("_global") == glob
            assert kw == jkw
    assert list(host_batches(sampler, ds, rank=0, world=1)) == \
        [(b, {}) for b in sampler]


# ----------------------------------------------- frame-sharded decode
def _deep_decoder(pndm=None):
    """A port-only sampler whose DiffNet reads 6 frames on either side, so
    a 6-frame block's halo reaches past its neighbour."""
    torch.manual_seed(0)
    dn = DiffNet(in_dim=MEL, encoder_hidden_dim=C, residual_layers=4,
                 residual_channels=16, dilation_cycle_length=2)
    with torch.no_grad():
        for p in dn.parameters():
            p.add_(0.05 * torch.randn_like(p))
    return GaussianDiffusion(dn, out_dim=MEL, K_step=12, norm_scale=6.0,
                             pndm_speedup=pndm).eval()


@pytest.mark.parametrize("pndm", [None, 3])
@pytest.mark.parametrize("devices", [["cpu", "cpu"], ["cpu"] * 4])
def test_frame_sharded_decode_matches_unsharded(devices, pndm):
    """Ancestral and PLMS decodes with the frames split in 2 and 4 blocks,
    with the draws of the unsharded decode: within 1e-5 of it."""
    dec = _deep_decoder(pndm)
    assert receptive_radius(dec.denoise_fn) == 6
    cond = torch.from_numpy(np.random.RandomState(1).randn(2, 24, C)
                            .astype(np.float32))
    mesh = make_mesh(devices=devices)
    with torch.no_grad():
        ref = dec.inference(cond, generator=torch.Generator().manual_seed(5))
        out = decode_frames_sharded(mesh, dec, cond,
                                    generator=torch.Generator()
                                    .manual_seed(5))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=0,
                               atol=SHARDED_ATOL)


def test_sharded_denoiser_windows():
    """No halo at the true ends, the receptive radius elsewhere, and a
    frame axis that does not divide refused."""
    sharded = FrameShardedDenoiser(_deep_decoder().denoise_fn, ["cpu"] * 4)
    assert sharded.windows(24) == [(0, 12, 0, 6), (0, 18, 6, 12),
                                   (6, 24, 6, 12), (12, 24, 6, 12)]
    with pytest.raises(ValueError, match="not divisible"):
        sharded.windows(26)


def test_frame_sharded_decode_matches_jax():
    """With x_T given and zero noise, against JAX's
    ``decode_frames_sharded`` on a 2-device mesh, at the decode-parity
    tolerance."""
    import flax.linen as fnn

    class Holder(fnn.Module):
        decoder: fnn.Module

    jdec, variables, port = decoder_twins(K=12)
    rng = np.random.RandomState(2)
    cond = rng.randn(2, 24, C).astype(np.float32)
    x_T = rng.randn(2, 24, MEL).astype(np.float32)
    jax_mesh = JaxMesh(np.asarray(jax.devices()[:2]).reshape(2, 1),
                       ("data", "model"))
    ref = jsp.decode_frames_sharded(
        jax_mesh, Holder(jdec), {"params": {"decoder": variables["params"]}},
        jnp.asarray(cond), x_T=jnp.asarray(x_T), zero_noise=True)
    with torch.no_grad():
        out = decode_frames_sharded(
            make_mesh(devices=["cpu", "cpu"]), port, torch.from_numpy(cond),
            x_T=torch.from_numpy(x_T), zero_noise=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.fixture(scope="module")
def tiny_synth_parts():
    model = flagship.build_model(tiny_model_config(), "cpu", seed=4,
                                 bert_config=TINY_BERT)
    vocoder = flagship.build_vocoder("cpu", 5, VOC_KW)
    kw = dict(tokenizer=WordIdTokenizer(), device="cpu",
              mel_stats={"mean": MEAN, "std": STD}, frame_quantum=64,
              max_frames_cap=512, upsample=UPSAMPLE, chunk_frames=16,
              halo_frames=4)
    return model, vocoder, kw


def test_synthesizer_frame_sharded_matches_unsharded(tiny_synth_parts):
    """``Synthesizer(frame_sharded_decode=True, vocoder_mode="sharded")``
    end to end: the mels within 1e-5 of the unsharded request's, the wavs
    of the chunked vocoder's."""
    model, vocoder, kw = tiny_synth_parts
    mesh = make_mesh(devices=["cpu", "cpu"])
    sharded = Synthesizer(model, vocoder, frame_sharded_decode=True,
                          vocoder_mode="sharded", mesh=mesh, **kw)
    plain = Synthesizer(model, vocoder, vocoder_mode="chunked", **kw)
    req = dict(prompts=PROMPTS, use_max=False, noise_scale=0.5, seed=3)
    wavs, mels = sharded.synthesize(SEQS, **req)
    ref_wavs, ref_mels = plain.synthesize(SEQS, **req)
    for m, r in zip(mels, ref_mels):
        np.testing.assert_allclose(m, r, rtol=0, atol=SHARDED_ATOL * STD)
    for w, r in zip(wavs, ref_wavs):
        assert w.shape == r.shape
        np.testing.assert_allclose(w, r, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="frame_sharded_decode"):
        Synthesizer(model, vocoder, frame_sharded_decode=True,
                    speculative=True, mesh=mesh, **kw).synthesize_async(
                        SEQS, prompts=PROMPTS)


@pytest.fixture(scope="module")
def f0voc():
    """tests/test_torch_streaming.py::f0voc, initialised under jit."""
    kw = dict(sampling_rate=24000, harmonic_num=2, **SMALL)
    jvoc = JaxF0Voc(**kw)
    variables = jax.jit(lambda k: jvoc.init(
        k, jnp.zeros((1, 16, 12)), jnp.zeros((1, 16, 1)),
        deterministic=True))(jax.random.PRNGKey(3))
    voc = F0AwareBigVGAN(**kw)
    load_jax_variables(voc, jax.device_get(variables))
    return jvoc, variables, voc.eval()


def test_vocode_sharded_matches_chunked_and_jax(f0voc):
    """The chunk batch of 5 chunks, padded to 6, over 2 devices: equal to
    ``vocode_chunked`` and within the vocoder tolerance of JAX's
    ``vocode_sharded`` on a 2-device mesh (the NSF phase offsets
    included)."""
    jvoc, variables, voc = f0voc
    mel = np.random.RandomState(6).randn(1, 80, 12).astype(np.float32)
    f0 = _vibrato(80)
    kw = dict(chunk_frames=16, halo_frames=HALO, upsample=UP,
              deterministic=True)
    jax_mesh = jmesh.make_mesh(devices=jax.devices()[:2])
    ref = jax_streaming.vocode_sharded(jax_mesh, jvoc, variables,
                                       jnp.asarray(mel), jnp.asarray(f0),
                                       **kw)
    args = (voc, torch.from_numpy(mel), torch.from_numpy(f0))
    with torch.no_grad():
        out = streaming.vocode_sharded(make_mesh(devices=["cpu", "cpu"]),
                                       *args, **kw).numpy()
        chunked = streaming.vocode_chunked(*args, **kw).numpy()
        full = voc(*args[1:], deterministic=True).numpy()
    np.testing.assert_allclose(out, chunked, rtol=0, atol=1e-6)
    np.testing.assert_allclose(out, np.asarray(ref), **VOC_TOL)
    assert np.abs(out - full)[:, MARGIN:-MARGIN].max() < 2e-3


# ------------------------------------------------ per-rank batches
@pytest.mark.parametrize("world", [2, 3])
def test_pipelines_give_the_same_rank_batches(corpus, world):  # noqa: F811
    """Each rank's batches from the Python collator, the C++ loader and the
    prefetching pipeline are equal bit for bit (checksums of every model
    key), and the ranks' real rows are the one-process global batch's,
    collated at the same buckets."""
    cfg = conf.compose("train", [f"path.root={corpus}"])
    ds_kw = dict(cfg["dataset"]["train"], seed=4)
    tok = WordPieceTokenizer.from_vocab_file(cfg["path"]["bert_vocab_file"])
    collator = PromptTTSCollator(tokenizer=tok)
    sampler = [[0, 3, 5], [1, 2, 4, 6, 7], [8]]

    def checksums(batches):
        return [{k: float(np.asarray(b[k], np.float64).sum())
                 for k in MODEL_BATCH_KEYS if k in b} for b in batches]

    per_rank = []
    for rank in range(world):
        entries = list(host_batches(sampler, AllWithSpkPromptNormDataset(
            **ds_kw), rank=rank, world=world, prompt_pad_to=None))
        got = {}
        for native in (False, True):
            ds = AllWithSpkPromptNormDataset(**ds_kw)
            out = []
            for e in entries:
                metas, kwargs, padding = entry_metas(ds, e, tok)
                out.append(finish(_collate_native(
                    metas, collator, ds.stats, **kwargs) if native else
                    collator([ds.load_item_features(m) for m in metas],
                             **kwargs), padding))
            got[native] = out
        got["prefetch"] = [b for b, _ in prefetch_batches(
            AllWithSpkPromptNormDataset(**ds_kw), entries, collator,
            model_keys=MODEL_BATCH_KEYS, num_workers=3)]
        assert checksums(got[False]) == checksums(got[True]) == \
            checksums(got["prefetch"])
        per_rank.append(got[False])
    ds = AllWithSpkPromptNormDataset(**ds_kw)
    for i, idx in enumerate(sampler):
        _, kw = next(iter(host_batches([idx], ds, rank=0, world=world)))
        metas = {j: ds.item_meta(j) for j in idx}
        whole = collator([ds.load_item_features(metas[j]) for j in idx],
                         t_phones=kw["t_phones"], t_frames=kw["t_frames"],
                         prompt_pad_to=None)
        slabs = [r[i] for r in per_rank]
        joined = {k: np.concatenate([s[k] for s in slabs])
                  for k in MODEL_BATCH_KEYS if k in whole}
        real = np.concatenate([s["batch_weight"] for s in slabs]) > 0
        assert real.sum() == len(idx)
        for k, v in joined.items():
            np.testing.assert_array_equal(v[real], whole[k], err_msg=k)


# --------------------------------------------------------- refusals
def test_mesh_and_model_axis_refusals(tiny_synth_parts):
    """The [data, model] fold of ``make_mesh`` (JAX's, transposed with
    ``model_spans_processes``), and the refusals that hold: a fold that
    does not cover the devices, no CUDA device, a pipelined decode that is
    frame-sharded too, and a pipeline whose stages break the DiffNet's
    dilation cycle (JAX's ValueError)."""
    model, vocoder, kw = tiny_synth_parts
    mesh = make_mesh(devices=["cpu", "cpu", "cpu"])
    assert mesh.shape == {"data": 3, "model": 1}
    assert mesh.data_devices == [torch.device("cpu")] * 3
    devs = [torch.device("cpu", i) for i in range(4)]
    mesh = make_mesh(model=2, devices=devs)
    assert mesh.shape == {"data": 2, "model": 2}
    assert mesh.model_devices(1) == devs[2:]
    assert make_mesh(model=2, devices=devs, model_spans_processes=True
                     ).model_devices(1) == [devs[1], devs[3]]
    with pytest.raises(ValueError):
        make_mesh(data=3, devices=["cpu", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()
    with pytest.raises(ValueError, match="frame_sharded_decode"):
        Synthesizer(model, vocoder, decode_pipelined=True,
                    frame_sharded_decode=True,
                    mesh=make_mesh(devices=["cpu"]), **kw)
    # the tiny DiffNet: 2 layers of dilation cycle 2 make one stage only
    synth = Synthesizer(model, vocoder, decode_pipelined=True,
                        mesh=make_mesh(model=2, devices=["cpu", "cpu"]), **kw)
    with pytest.raises(ValueError, match="multiple of the dilation cycle"):
        synth._decoder.inference(torch.zeros(1, 8, model.decoder.denoise_fn
                                             .residual_layers[0]
                                             .conditioner_projection
                                             .in_channels),
                                 zero_noise=True,
                                 x_T=torch.zeros(1, 8, 20))
