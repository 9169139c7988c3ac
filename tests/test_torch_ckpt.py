"""The port's checkpoint bridge against the JAX package's (`io/dgq_ckpt.py`,
`io/convert.py`, `io/hf_loader.py`) and its time-aware stacking
(`calib/act_calib.py:stack_time_qstates`).

Every comparison is bit for bit (`assert_array_equal`): both packages keep
float32 and only rename and reshape. Files written by `dgq_tpu.io.dgq_ckpt`
load into the port and files written by the port load into `dgq_tpu`, with
AdaRound alphas, mid-axis, last-axis and mixed-axis group deltas, per-tensor
points and delta-only softmax ('sm') keys. The weights are drawn by the port
and handed to JAX through the weight bridge, as in test_torch_pipeline.py.
"""
import logging
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dgq_tpu.calib.act_calib import stack_time_qstates as j_stack  # noqa: E402
from dgq_tpu.io import convert as JC, dgq_ckpt as JK, hf_loader as JH  # noqa: E402
from dgq_tpu.models.qconfig import GroupQParams as JG  # noqa: E402
from dgq_tpu.models.unet_sd import sd_unet_spec  # noqa: E402
from dgq_tpu.ops.pallas.group_conv import fused_eligible as j_fused_eligible  # noqa: E402
from dgq_tpu.quant.affine import QParams as JQP  # noqa: E402
from dgq_tpu_torch.calib.act_calib import stack_time_qstates as t_stack  # noqa: E402
from dgq_tpu_torch.calib.weight_calib import init_weight_qparams  # noqa: E402
from dgq_tpu_torch.io import convert as TC, dgq_ckpt as TK, hf_loader as TH  # noqa: E402
from dgq_tpu_torch.io.convert import params_to_numpy  # noqa: E402
from dgq_tpu_torch.models import layers as TL, unet_sd as TU  # noqa: E402
from dgq_tpu_torch.models.qconfig import GroupQParams as TG, QConfig as TQ  # noqa: E402
from dgq_tpu_torch.ops.group_conv import fused_eligible as t_fused_eligible  # noqa: E402
from dgq_tpu_torch.quant.adaround import adaround_init_alpha  # noqa: E402
from dgq_tpu_torch.quant.affine import QParams as TQP  # noqa: E402

BASE, CROSS = 32, 64
CONV = "down_blocks.0.resnets.0.conv1"          # 3x3, C = 32, 8x8 output at 8x8 latents
CONV2 = "down_blocks.1.resnets.0.conv1"         # 3x3, C = 32 -> 64
LIN = "mid_block.attentions.0.transformer_blocks.0.attn1.to_q"
ATT_Q = "mid_block.attentions.0.transformer_blocks.0.attn1.aqtizer_q"
ATT_W = "mid_block.attentions.0.transformer_blocks.0.attn1.aqtizer_w"
ATT_W2 = "up_blocks.1.attentions.0.transformer_blocks.0.attn2.aqtizer_w"
ALPHA_LAYERS = (CONV, "time_embedding.linear_1")


def _np(x):
    return np.asarray(x.detach().cpu().float()) if torch.is_tensor(x) else np.asarray(x)


@pytest.fixture(scope="module")
def tiny():
    """(spec, port params, port wqp, port alphas, their JAX-layout twins)."""
    spec = sd_unet_spec(base=BASE, cross=CROSS)
    tp = TU.init_unet_sd(torch.Generator().manual_seed(0), "cpu", spec=spec)
    twqp = init_weight_qparams(tp, spec, 4)
    talphas = {n: adaround_init_alpha(tp[n]["w"], twqp[n].delta) for n in ALPHA_LAYERS}
    jp = jax.tree.map(jnp.asarray, params_to_numpy(tp, spec))
    kinds = {n: k for n, k, _ in spec}

    def j_qp(qp, kind):  # per-out-channel (O,1,1,1) / (O,1) -> (1,1,1,O) / (1,O)
        shape = (1, 1, 1, -1) if kind == "conv" else (1, -1)
        return JQP(jnp.asarray(_np(qp.delta).reshape(shape)),
                   jnp.asarray(_np(qp.zero_point).reshape(shape)))

    jwqp = {n: j_qp(qp, kinds[n]) for n, qp in twqp.items()}
    jalphas = {n: (JC.conv_w_to_jax(_np(a)) if kinds[n] == "conv" else jnp.asarray(_np(a).T))
               for n, a in talphas.items()}
    return spec, tp, twqp, talphas, jp, jwqp, jalphas


def _j_slot(t):
    """One JAX act_{t} qstate: per-tensor, mid-axis, last-axis and 'sm'
    points, with values that differ between slots."""
    ckk = BASE * 9
    s = 1.0 + 0.25 * t
    return {"a": {
        LIN: JQP(jnp.asarray(0.03 * s), jnp.asarray(7.0 + t)),
        ATT_W: JQP(jnp.asarray(1.0 / 255.0 * s), jnp.asarray(0.0)),
        CONV: JG(jnp.linspace(0.01, 0.2, ckk) * s, jnp.arange(ckk, dtype=jnp.float32) % 7,
                 jnp.ones((1,)), jnp.zeros((1,))),
        ATT_Q: JG(jnp.ones((1,)), jnp.zeros((1,)), jnp.linspace(0.02, 0.1, 16) * s,
                  jnp.ones((16,)) * t),
    }, "sm": {ATT_W2: jnp.asarray(0.125 * s)}}


def _assert_qstate_equal(tq, jq):
    assert set(tq) >= {"a", "sm"} and set(tq["a"]) == set(jq["a"])
    assert set(tq["sm"]) == set(jq.get("sm", {}))
    for name, jl in jq["a"].items():
        tl = tq["a"][name]
        assert type(tl).__name__ == type(jl).__name__, name
        fields = (("delta_mid", "zp_mid", "delta_last", "zp_last") if isinstance(jl, JG)
                  else ("delta", "zero_point"))
        for f in fields:
            np.testing.assert_array_equal(_np(getattr(tl, f)), np.asarray(getattr(jl, f)),
                                          err_msg=f"{name}.{f}")
    for name, jd in jq.get("sm", {}).items():
        np.testing.assert_array_equal(_np(tq["sm"][name]), np.asarray(jd))


def _assert_weights_equal(spec, tp, twqp, talphas, jp, jwqp, jalphas):
    """Port structures (OIHW) against JAX ones (HWIO), bit for bit."""
    jnp_params = jax.tree.map(np.asarray, jp)
    tnp = params_to_numpy(tp, spec)
    for name, _, _ in spec:
        for leaf, v in jnp_params[name].items():
            if v is None:
                assert tnp[name].get(leaf) is None
            else:
                np.testing.assert_array_equal(tnp[name][leaf], v, err_msg=f"{name}.{leaf}")
    assert set(twqp) == set(jwqp)
    for name, jq in jwqp.items():
        kind = dict((n, k) for n, k, _ in spec)[name]
        want = (-1, 1, 1, 1) if kind == "conv" else (-1, 1)
        assert tuple(twqp[name].delta.shape) == tuple(np.empty(
            int(np.asarray(jq.delta).size)).reshape(want).shape)
        np.testing.assert_array_equal(_np(twqp[name].delta).reshape(-1),
                                      np.asarray(jq.delta).reshape(-1))
        np.testing.assert_array_equal(_np(twqp[name].zero_point).reshape(-1),
                                      np.asarray(jq.zero_point).reshape(-1))
    assert set(talphas or {}) == set(jalphas or {})
    for name, ja in (jalphas or {}).items():
        ja = np.asarray(ja)
        want = JC.conv_w_to_torch(ja) if ja.ndim == 4 else ja.T
        np.testing.assert_array_equal(_np(talphas[name]), want)


def test_jax_written_weight_only_loads_bit_for_bit(tmp_path, tiny):
    spec, tp, twqp, talphas, jp, jwqp, jalphas = tiny
    path = str(tmp_path / "cali_ckpt.pth_weight_only")
    JK.save_weight_only(path, jp, jwqp, spec, alphas=jalphas)
    p2, wqp2, al2 = TK.load_weight_only(path, spec, device="cpu")
    _assert_weights_equal(spec, p2, wqp2, al2, jp, jwqp, jalphas)
    # and the port's own structures are what was written
    for name in twqp:
        assert torch.equal(wqp2[name].delta, twqp[name].delta)
        assert torch.equal(p2[name]["w"], tp[name]["w"])
    for name in ALPHA_LAYERS:
        assert torch.equal(al2[name], talphas[name])


def test_port_written_weight_only_loads_into_jax(tmp_path, tiny):
    spec, tp, twqp, talphas, _, _, _ = tiny
    path = str(tmp_path / "cali_ckpt.pth_weight_only")
    TK.save_weight_only(path, tp, twqp, spec, alphas=talphas)
    jp2, jwqp2, jal2 = JK.load_weight_only(path, spec)
    _assert_weights_equal(spec, tp, twqp, talphas, jp2, jwqp2, jal2)
    # the files are the same dicts, key for key
    jpath = str(tmp_path / "j.pth_weight_only")
    JK.save_weight_only(jpath, jp2, jwqp2, spec, alphas=jal2)
    a = torch.load(path, weights_only=False)["weight"]
    b = torch.load(jpath, weights_only=False)["weight"]
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def test_jax_written_act_and_merged_load_bit_for_bit(tmp_path, tiny):
    spec, tp, twqp, talphas, jp, jwqp, jalphas = tiny
    per_t = {f"act_{t}": _j_slot(t) for t in range(3)}
    wpath, apath = str(tmp_path / "w.pth_weight_only"), str(tmp_path / "a_w4a8g8.pth")
    JK.save_weight_only(wpath, jp, jwqp, spec, alphas=jalphas)
    JK.save_act_ckpt(apath, per_t, spec)
    mpath = str(tmp_path / "m_w4a8g8.pth")
    JK.merge_ckpts(wpath, apath, mpath)
    for path, has_weights in ((apath, False), (mpath, True)):
        p, w, al, pt, gl = TK.load_merged(path, spec, device="cpu")
        jpar, jw, jal, jpt, jgl = JK.load_merged(path, spec)
        assert gl == jgl == (CONV,)
        assert set(pt) == set(jpt) == set(per_t)
        for key in per_t:
            _assert_qstate_equal(pt[key], jpt[key])
            _assert_qstate_equal(pt[key], per_t[key])
        if has_weights:
            _assert_weights_equal(spec, p, w, al, jp, jwqp, jalphas)
        else:
            assert p is None and w is None and al is None


def test_port_written_merged_loads_into_jax(tmp_path, tiny):
    spec, tp, twqp, talphas, _, _, _ = tiny
    per_t = {f"act_{t}": _t_from_j(_j_slot(t)) for t in range(3)}
    path = str(tmp_path / "m_w4a8g8.pth")
    TK.save_merged(path, tp, twqp, spec, per_t, alphas=talphas)
    jp, jw, jal, jpt, jgl = JK.load_merged(path, spec)
    assert jgl == (CONV,)
    _assert_weights_equal(spec, tp, twqp, talphas, jp, jw, jal)
    for key in per_t:
        _assert_qstate_equal(per_t[key], jpt[key])
    # the raw activation dicts match the JAX writer's, in shape and bits
    raw = torch.load(path, weights_only=False)
    jpath = str(tmp_path / "j.pth")
    JK.save_act_ckpt(jpath, {k: _j_slot(int(k[4:])) for k in per_t}, spec)
    jraw = torch.load(jpath, weights_only=False)
    for key in per_t:
        assert set(raw[key]) == set(jraw[key])
        for k in raw[key]:
            assert tuple(raw[key][k].shape) == tuple(jraw[key][k].shape), k
            assert torch.equal(raw[key][k], jraw[key][k]), k
    assert tuple(raw["act_0"][f"model.{CONV}.aqtizer.delta"].shape) == (1, BASE * 9, 1)
    assert tuple(raw["act_0"][f"model.{ATT_Q}.delta"].shape) == (1, 1, 16)
    assert f"model.{ATT_W2}.zero_point" not in raw["act_0"]


def test_slot_of_a_stacked_state_saves_compactly(tmp_path, tiny):
    """A slot cut from a [T]-stacked state is written as its own elements
    (torch.save would otherwise store the whole stacked storage)."""
    spec = tiny[0]
    stacked = t_stack({f"act_{t}": _t_from_j(_j_slot(t)) for t in range(3)})
    one = {k: {n: (type(v)(*(x[1] for x in (v.delta_mid, v.zp_mid, v.delta_last, v.zp_last)))
                   if isinstance(v, TG) else TQP(v.delta[1], v.zero_point[1])
                   if isinstance(v, TQP) else v[1]) for n, v in sub.items()}
           for k, sub in stacked.items()}
    path = str(tmp_path / "one.pth")
    TK.save_act_ckpt(path, {"act_0": one}, spec)
    raw = torch.load(path, weights_only=False)["act_0"]
    for k, v in raw.items():
        assert v.untyped_storage().nbytes() == v.numel() * v.element_size(), k
    qs, _ = TK.act_dict_to_qstate({k: v.numpy() for k, v in raw.items()}, spec, device="cpu")
    _assert_qstate_equal(qs, _j_slot(1))


def test_qstate_to_act_dict_refuses_a_point_in_a_and_sm(tiny):
    spec = tiny[0]
    qs = {"a": {ATT_W: TQP(torch.tensor(0.1), torch.tensor(0.0))},
          "sm": {ATT_W: torch.tensor(0.5)}}
    with pytest.raises(ValueError, match="both a uniform"):
        TK.qstate_to_act_dict(qs, spec)
    with pytest.raises(ValueError, match="both a uniform"):
        JK.qstate_to_act_dict({"a": {ATT_W: JQP(jnp.asarray(0.1), jnp.asarray(0.0))},
                               "sm": {ATT_W: jnp.asarray(0.5)}}, spec)


@pytest.mark.parametrize("key", ["model.a.b.aqtizer.delta", "model.a.attn1.aqtizer_q.delta",
                                 "model.a.attn1.aqtizer_w.delta", "model.a.b.aqtizer.zero_point",
                                 "a.b.aqtizer.delta", "model.a.b.wqtizer.delta"])
def test_act_key_names(key):
    name = TK._act_key_to_name(key)
    assert name == JK._act_key_to_name(key)
    if name is not None:
        assert TK._name_to_act_key(name) == JK._name_to_act_key(name) == key[:-len(".delta")]


def test_merge_keeps_bf16(tmp_path):
    w = {"weight": {"model.conv_in.w": torch.randn(4, 4, 3, 3).bfloat16(),
                    "model.conv_in.wqtizer.delta": torch.rand(4, 1, 1, 1).half()}}
    a = {"act_0": {"model.conv_in.aqtizer.delta": torch.tensor(0.1, dtype=torch.bfloat16)}}
    torch.save(w, tmp_path / "w.pth")
    torch.save(a, tmp_path / "a.pth")
    TK.merge_ckpts(str(tmp_path / "w.pth"), str(tmp_path / "a.pth"), str(tmp_path / "m.pth"))
    m = torch.load(tmp_path / "m.pth", weights_only=False)
    assert m["weight"]["model.conv_in.w"].dtype == torch.bfloat16
    assert m["weight"]["model.conv_in.wqtizer.delta"].dtype == torch.float16
    assert torch.equal(m["weight"]["model.conv_in.w"], w["weight"]["model.conv_in.w"])
    assert m["act_0"]["model.conv_in.aqtizer.delta"].dtype == torch.bfloat16
    # load_pth, by contrast, reads every tensor as float32, exactly
    loaded = TK.load_pth(str(tmp_path / "m.pth"))
    assert loaded["weight"]["model.conv_in.w"].dtype == np.float32
    np.testing.assert_array_equal(loaded["weight"]["model.conv_in.w"],
                                  w["weight"]["model.conv_in.w"].float().numpy())


def _mixed_per_t(n):
    """CONV mid-axis at slot 0 and last-axis (L = 64, the 8x8 output) after;
    CONV2 mid-axis at every slot; per-tensor points and 'sm' deltas."""
    ckk, ckk2 = BASE * 9, BASE * 9
    out = {}
    for t in range(n):
        s = 1.0 + 0.5 * t
        conv = (JG(jnp.linspace(0.01, 0.2, ckk) * s, jnp.ones((ckk,)), jnp.ones((1,)),
                   jnp.zeros((1,))) if t == 0 else
                JG(jnp.ones((1,)), jnp.zeros((1,)), jnp.linspace(0.02, 0.1, 64) * s,
                   jnp.ones((64,))))
        out[f"act_{t}"] = {"a": {
            CONV: conv,
            CONV2: JG(jnp.linspace(0.01, 0.1, ckk2) * s, jnp.full((ckk2,), 3.0),
                      jnp.ones((1,)), jnp.zeros((1,))),
            LIN: JQP(jnp.asarray(0.05 * s), jnp.asarray(128.0)),
        }, "sm": {ATT_W2: jnp.asarray(0.25 * s)}}
    return out


def test_stack_time_qstates_matches_jax_and_logs_mixed(tmp_path, tiny, caplog):
    spec = tiny[0]
    jper = _mixed_per_t(3)
    path = str(tmp_path / "mixed.pth")
    JK.save_act_ckpt(path, jper, spec)
    _, _, _, tper, gl = TK.load_merged(path, spec, device="cpu")
    assert gl == (CONV, CONV2)
    with caplog.at_level(logging.INFO, logger="dgq_tpu_torch"):
        ts = t_stack(tper)
    assert "mixed-axis group layers" in caplog.text and CONV in caplog.text
    assert CONV2 not in caplog.text.split("used):")[-1]
    js = j_stack(jper)
    _assert_qstate_equal(ts, js)
    g = ts["a"][CONV]
    assert tuple(g.delta_mid.shape) == (3, BASE * 9) and tuple(g.delta_last.shape) == (3, 64)
    assert tuple(ts["a"][LIN].delta.shape) == (3,) and tuple(ts["sm"][ATT_W2].shape) == (3,)


def test_mixed_axis_layer_fails_the_fused_gate(tiny, monkeypatch):
    """A mixed-axis layer's full-length delta_last keeps it off the fused
    kernel at every slot (both packages' gates), while the other group conv
    takes the kernel; a tiny forward under group_conv_impl='fused' sends
    only that other layer to `group_quant_conv`."""
    spec, tp = tiny[0], tiny[1]
    jper = _mixed_per_t(2)
    tper = {k: _t_from_j(v) for k, v in jper.items()}
    ts, js = t_stack(tper), j_stack(jper)
    x_shape = (2, 8, 8, BASE)
    for slot in range(2):
        tg = TG(*(getattr(ts["a"][CONV], f)[slot] for f in (
            "delta_mid", "zp_mid", "delta_last", "zp_last")))
        jg = JG(*(getattr(js["a"][CONV], f)[slot] for f in (
            "delta_mid", "zp_mid", "delta_last", "zp_last")))
        assert not t_fused_eligible(x_shape, BASE, 3, 3, 1, 1, tg)
        assert not j_fused_eligible(x_shape, BASE, 3, 3, 1, 1, jg, dtype_bytes=4)
        tg2 = TG(*(getattr(ts["a"][CONV2], f)[slot] for f in (
            "delta_mid", "zp_mid", "delta_last", "zp_last")))
        assert t_fused_eligible(x_shape, 2 * BASE, 3, 3, 1, 1, tg2)

    calls = []
    real = TL.group_quant_conv

    def counting(x, w, *a, **kw):
        calls.append((tuple(x.shape), tuple(w.shape)))
        return real(x, w, *a, **kw)

    monkeypatch.setattr(TL, "group_quant_conv", counting)
    cfg = TQ(w_bits=8, a_bits=8, use_wq=True, use_aq=True, group_conv_layers=(CONV, CONV2),
             group_conv_impl="fused")
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(2, 8, 8, 4).astype(np.float32))
    ehs = torch.from_numpy(rng.randn(2, 77, CROSS).astype(np.float32))
    qs = {k: {n: v for n, v in sub.items()} for k, sub in ts.items()}
    qs1 = {k: {n: (TG(*(getattr(v, f)[1] for f in ("delta_mid", "zp_mid", "delta_last",
                                                     "zp_last")))
                   if isinstance(v, TG) else TQP(v.delta[1], v.zero_point[1])
                   if isinstance(v, TQP) else v[1]) for n, v in sub.items()}
           for k, sub in qs.items()}
    out = TU.unet_sd_apply(tp, x, torch.tensor([500, 500], dtype=torch.int32), ehs,
                           qstate=qs1, cfg=cfg)
    assert bool(torch.isfinite(out).all())
    # CONV2 (input 32 channels at 4x4, weight (3, 3, 32, 64)) took the kernel; CONV did not
    assert calls == [((2, 4, 4, BASE), (3, 3, BASE, 2 * BASE))]


def _t_from_j(jq):
    def conv(x):
        if isinstance(x, JG):
            return TG(*(torch.from_numpy(np.array(v)) for v in (
                x.delta_mid, x.zp_mid, x.delta_last, x.zp_last)))
        if isinstance(x, JQP):
            return TQP(torch.from_numpy(np.array(x.delta)), torch.from_numpy(np.array(x.zero_point)))
        return torch.from_numpy(np.array(x))
    return {k: {n: conv(v) for n, v in sub.items()} for k, sub in jq.items()}


def test_unet_state_dict_bridge_matches_jax(tmp_path, tiny):
    spec, tp = tiny[0], tiny[1]
    state = TC.params_to_torch_unet(tp, spec)
    assert tuple(state[f"{CONV}.weight"].shape) == (BASE, BASE, 3, 3)
    assert tuple(state[f"{LIN}.weight"].shape) == (BASE * 4, BASE * 4)
    np_state = {k: v.numpy() for k, v in state.items()}
    jp = JC.torch_unet_to_params(np_state, spec)
    tp2 = TC.torch_unet_to_params(np_state, spec, device="cpu")
    tnp = params_to_numpy(tp2, spec)
    for name, _, _ in spec:
        for leaf, v in jp[name].items():
            if v is None:
                assert tp2[name].get("b") is None
            else:
                np.testing.assert_array_equal(tnp[name][leaf], np.asarray(v))
    jstate = JC.params_to_torch_unet(jp, spec)
    assert set(jstate) == set(state)
    for k in state:
        np.testing.assert_array_equal(state[k].numpy(), jstate[k])


@pytest.mark.parametrize("kind,shape", [("conv", (8, 1, 1, 1)), ("conv", (8,)),
                                        ("conv", (1, 1, 1, 8)), ("linear", (8, 1)),
                                        ("linear", (1, 8)), ("conv", ()), ("linear", ())])
def test_channel_qp_shape(kind, shape):
    a = np.arange(1, 1 + int(np.prod(shape)), dtype=np.float32).reshape(shape)
    t = TC.channel_qp_to_torch(a, kind, device="cpu")
    want = () if not shape else ((8, 1, 1, 1) if kind == "conv" else (8, 1))
    assert tuple(t.shape) == want
    np.testing.assert_array_equal(t.numpy().reshape(-1), a.reshape(-1))
    # the JAX package holds the same values out channel last
    np.testing.assert_array_equal(np.asarray(JC.channel_qp_to_jax(a, kind)).reshape(-1),
                                  a.reshape(-1))


def _state():
    rng = np.random.RandomState(3)
    return {"a.weight": rng.randn(3, 2).astype(np.float32),
            "b.bias": rng.randn(3).astype(np.float32)}


def test_hf_loader_file_dir_and_state_dict_key(tmp_path):
    st = _state()
    tensors = {k: torch.from_numpy(v) for k, v in st.items()}
    (tmp_path / "snap").mkdir()
    torch.save(tensors, tmp_path / "snap" / "diffusion_pytorch_model.bin")
    torch.save({"state_dict": {k: v.half() for k, v in tensors.items()}, "epoch": 3},
               tmp_path / "wrapped.bin")
    (tmp_path / "other").mkdir()
    torch.save(tensors, tmp_path / "other" / "zzz.pth")
    for path in (tmp_path / "snap", tmp_path / "snap" / "diffusion_pytorch_model.bin",
                 tmp_path / "wrapped.bin", tmp_path / "other"):
        got, want = TH.load_state_dict_any(str(path)), JH.load_state_dict_any(str(path))
        assert TH.resolve_state_file(str(path)) == JH.resolve_state_file(str(path))
        assert set(got) == set(want) == set(st)
        for k in st:
            assert got[k].dtype == np.float32
            np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(FileNotFoundError):
        TH.resolve_state_file(str(tmp_path / "missing"))


def test_hf_loader_safetensors(tmp_path, monkeypatch):
    safetensors_torch = pytest.importorskip("safetensors.torch")
    st = _state()
    path = str(tmp_path / "model.safetensors")
    safetensors_torch.save_file({"a.weight": torch.from_numpy(st["a.weight"]).bfloat16(),
                                 "b.bias": torch.from_numpy(st["b.bias"]),
                                 "ids": torch.arange(4)}, path)
    got = TH.load_state_dict_any(str(tmp_path))
    assert got["a.weight"].dtype == np.float32 and got["ids"].dtype == np.int64
    np.testing.assert_array_equal(got["b.bias"], st["b.bias"])
    np.testing.assert_array_equal(
        got["a.weight"], torch.from_numpy(st["a.weight"]).bfloat16().float().numpy())
    monkeypatch.setitem(__import__("sys").modules, "safetensors", None)
    with pytest.raises(ImportError, match=os.path.basename(path)):
        TH.load_state_dict_any(path)
