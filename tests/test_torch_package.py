"""The PyTorch port as a package: it imports without JAX and nothing of the
JAX package, its entry points default to the card, its checkpoints load
with a plain ``load_state_dict``, and its IOAdapter matches the JAX one."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests._torch_threads import cap_torch_threads  # noqa: F401

import jax.numpy as jnp

import ptlflow_tpu
import ptlflow_tpu_torch
from ptlflow_tpu.utils.io_adapter import IOAdapter as JIOAdapter
from ptlflow_tpu_torch.utils import ckpt as tckpt
from ptlflow_tpu_torch.utils.io_adapter import IOAdapter

ROOT = pathlib.Path(__file__).resolve().parent.parent


def test_imports_without_jax():
    """In a fresh interpreter: this test process already holds JAX."""
    code = ("import sys, ptlflow_tpu_torch, ptlflow_tpu_torch.parallel, "
            "ptlflow_tpu_torch.ops.warp; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "bad = [m for m in sys.modules if m == 'ptlflow_tpu' "
            "or m.startswith('ptlflow_tpu.')]; "
            "assert not bad, bad")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(mod):
    """jax or the JAX package, by exact module name: ptlflow_tpu_torch
    shares the prefix and is allowed."""
    return any(mod == top or mod.startswith(top + ".")
               for top in ("jax", "jaxlib", "ptlflow_tpu"))


@pytest.mark.parametrize("mod,bad", [("jax", True), ("jax.numpy", True),
                                     ("ptlflow_tpu", True),
                                     ("ptlflow_tpu.ops", True),
                                     ("ptlflow_tpu_torch", False),
                                     ("ptlflow_tpu_torch.ops", False),
                                     ("jaxtyping", False)])
def test_import_scan_matches_exact_names(mod, bad):
    assert _forbidden(mod) is bad


def test_port_sources_import_no_jax():
    files = sorted((ROOT / "ptlflow_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    offenders = [(f.name, m) for f in files for m in _imported_modules(f)
                 if _forbidden(m)]
    assert not offenders


PORTED = ["ccmr", "ccmr_p", "craft", "csflow", "dicl", "dip", "dpflow",
          "fastflownet", "flow1d", "flow_anything", "flowformer",
          "flowformer_pp", "flownet2", "flownetc", "flownetcs", "flownetcss",
          "flownets", "flownetsd", "flowseek_m", "flowseek_t", "gma",
          "gmflow", "gmflow_p", "gmflow_p_sc2", "gmflow_p_sc2_ref6",
          "gmflow_refine", "gmflownet", "gmflownet_mix", "hd3",
          "hd3_ctxt", "irr_pwc", "irr_pwcnet", "irr_pwcnet_irr", "lcv_raft",
          "lcv_raft_small", "liteflownet", "liteflownet2",
          "liteflownet2_pseudoreg", "liteflownet3", "liteflownet3_pseudoreg",
          "liteflownet3s", "liteflownet3s_pseudoreg", "llaflow",
          "llaflow_raft", "maskflownet", "maskflownet_s", "matchflow",
          "matchflow_raft", "memflow", "memflow_t", "memfof", "ms_raft_p",
          "neuflow", "neuflow2", "pwcnet",
          "pwcnet_nodc", "raft", "raft_small", "rapidflow", "rapidflow_it1",
          "rapidflow_it2", "rapidflow_it3", "rapidflow_it6", "recover_cx",
          "recover_mn", "recover_rn", "rpknet", "scopeflow", "scv4", "scv8",
          "sea_raft", "sea_raft_l", "sea_raft_m", "sea_raft_s",
          "separableflow", "skflow", "splatflow", "starflow", "streamflow",
          "unimatch", "unimatch_sc2", "unimatch_sc2_ref6", "vcn",
          "vcn_small", "videoflow_bof", "videoflow_mof", "waft_dav2_a1",
          "waft_dav2_a2", "waft_dinov3_a2", "waft_twins_a2"]


def test_registry():
    """The 90 ported names, all of the JAX package's; the trainable ones
    are the JAX package's trainable names among them (``flowformer_pp``,
    the VideoFlows, ``memfof``, ``splatflow``, ``flow_anything``, the
    FlowSeeks, the CCMRs, the seven LiteFlowNets and STaRFlow are not
    trainable)."""
    assert ptlflow_tpu_torch.get_model_names() == PORTED
    assert len(PORTED) == 90
    assert ptlflow_tpu_torch.get_trainable_model_names() == [
        n for n in PORTED if n in ptlflow_tpu.get_trainable_model_names()]
    for name in ("flowformer_pp", "videoflow_bof", "videoflow_mof",
                 "memfof", "splatflow", "flow_anything", "flowseek_t",
                 "flowseek_m", "ccmr", "ccmr_p", "liteflownet", "liteflownet2",
                 "liteflownet2_pseudoreg", "liteflownet3",
                 "liteflownet3_pseudoreg", "liteflownet3s",
                 "liteflownet3s_pseudoreg", "starflow"):
        assert name not in ptlflow_tpu_torch.get_trainable_model_names()
    for name in ("craft", "neuflow2", "streamflow", "csflow", "llaflow",
                 "llaflow_raft", "recover_cx", "recover_mn", "recover_rn",
                 "waft_dav2_a1", "waft_dav2_a2", "waft_dinov3_a2",
                 "waft_twins_a2", "dip", "flow1d", "gmflownet",
                 "gmflownet_mix", "matchflow", "matchflow_raft", "scv4",
                 "scv8", "ms_raft_p", "separableflow", "pwcnet",
                 "pwcnet_nodc", "irr_pwc", "scopeflow", "irr_pwcnet",
                 "irr_pwcnet_irr", "flownets", "flownetc", "flownetsd",
                 "flownetcs", "flownetcss", "flownet2", "fastflownet",
                 "maskflownet", "maskflownet_s", "hd3", "hd3_ctxt", "dicl",
                 "vcn", "vcn_small", "neuflow", "gmflow", "gmflow_refine",
                 "unimatch", "unimatch_sc2", "unimatch_sc2_ref6", "gmflow_p",
                 "gmflow_p_sc2", "gmflow_p_sc2_ref6"):
        assert name in ptlflow_tpu_torch.get_trainable_model_names()
    assert ptlflow_tpu_torch.get_ptlflow_trained_model_names() == [
        "ccmr", "ccmr_p", "dpflow", "flowseek_m", "flowseek_t", "gma",
        "hd3", "hd3_ctxt", "ms_raft_p", "pwcnet", "raft", "raft_small", "rapidflow",
        "rapidflow_it1", "rapidflow_it2", "rapidflow_it3", "rapidflow_it6",
        "rpknet", "waft_dav2_a1", "waft_dav2_a2", "waft_twins_a2"]
    assert ptlflow_tpu_torch.get_model_reference("raft").__name__ == "raft"
    with pytest.raises(ValueError):
        ptlflow_tpu_torch.get_model_reference("no_such_model")


def test_registry_names_and_flags_are_the_jax_packages():
    """The port's registry is the JAX package's: the same names, trainable
    and ptlflow-trained exactly where the JAX package says so."""
    names = ptlflow_tpu_torch.get_model_names()
    assert set(names) == set(ptlflow_tpu.get_model_names())
    for fn in ("get_trainable_model_names",
               "get_ptlflow_trained_model_names"):
        assert (set(getattr(ptlflow_tpu_torch, fn)())
                == set(getattr(ptlflow_tpu, fn)())), fn


@pytest.mark.parametrize("name", ["sea_raft_m", "gma"])
def test_init_params_is_seeded(name):
    """``init_params(seed)`` gives the same tensors on two calls, every
    layer kind included (Linear, LayerNorm, Embedding, the layer scales),
    draws nothing from torch's global generator, and starts the layer
    scales where the JAX package does: ConvNeXt's at 1e-6, GMA's
    aggregator at 0."""
    model = ptlflow_tpu_torch.get_model_reference(name)(iters=1)
    torch.manual_seed(123)
    want_global = torch.rand(4)
    torch.manual_seed(123)
    first = {k: v.clone() for k, v in model.init_params(5).state_dict().items()}
    assert torch.equal(torch.rand(4), want_global)
    # overwrite every weight and statistic, then draw the same seed again
    for t in model.state_dict().values():
        if t.is_floating_point():
            t.fill_(7)
    second = model.init_params(5).state_dict()
    for k, v in first.items():
        torch.testing.assert_close(second[k], v, rtol=0, atol=0, msg=k)
    other = model.init_params(6).state_dict()
    if name == "gma":
        assert model.update_block.aggregator.gamma.item() == 0.0
        emb = "att.pos_emb.rel_height.weight"
        assert not torch.equal(other[emb], first[emb])
        assert abs(first[emb].std().item() - 1) < 0.05
    else:
        gamma = model.update_block.refine[0].gamma
        assert torch.all(gamma == 1e-6)
        lin = "update_block.refine.0.pwconv1.weight"
        assert not torch.equal(other[lin], first[lin])
        assert first[lin].abs().max() <= 384 ** -0.5
        assert torch.all(first["update_block.refine.0.norm.weight"] == 1)


def test_get_model_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card, so the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        ptlflow_tpu_torch.get_model("raft_small")
    model = ptlflow_tpu_torch.get_model("raft_small", device="cpu")
    assert model.device.type == "cpu" and not model.training


def test_io_adapter_defaults_to_the_card():
    """Without a model or a device, IOAdapter puts inputs on the card, as
    get_model does, and raises where CUDA is absent."""
    if torch.cuda.is_available():
        assert IOAdapter(output_stride=8).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        IOAdapter()
    assert IOAdapter(device="cpu").device.type == "cpu"


def test_seeded_weights_repeat():
    a = ptlflow_tpu_torch.get_model("raft_small", device="cpu")
    b = ptlflow_tpu_torch.get_model("raft_small", device="cpu")
    c = ptlflow_tpu_torch.get_model("raft_small", device="cpu").init_params(1)
    for k, v in a.state_dict().items():
        torch.testing.assert_close(v, b.state_dict()[k], rtol=0, atol=0)
    assert not torch.equal(a.fnet.conv1.weight, c.fnet.conv1.weight)


def test_checkpoint_round_trip(tmp_path):
    """A Lightning-style .ckpt (state_dict + hyper_parameters, harness keys
    dropped) loads with strict load_state_dict."""
    src = ptlflow_tpu_torch.get_model("raft_small", device="cpu").init_params(7)
    state = dict(src.state_dict())
    state["loss_fn.weight"] = torch.zeros(1)
    path = tmp_path / "model.ckpt"
    torch.save({"state_dict": state,
                "hyper_parameters": {"train_size": [368, 496]}}, path)
    dst = ptlflow_tpu_torch.get_model("raft_small", ckpt_path=str(path),
                                      device="cpu")
    for k, v in src.state_dict().items():
        torch.testing.assert_close(dst.state_dict()[k], v, rtol=0, atol=0)
    assert dst.train_size == (368, 496)


@pytest.mark.parametrize("name,extra", [
    ("memflow", "network."), ("lcv_raft", "corr_block.eye"),
    ("rapidflow", "fnet.rec_stage.blocks.0.conv_dw.weight_h"),
    ("rpknet", "fnet.rec_stage.blocks.0.layer_scale_1"),
    ("dpflow", "fnet.up_gru.weight"),
    ("craft", "corr_fn.setrans.key.weight"),
    ("videoflow_mof", "update_block.encoder.init_hidden_state"),
    ("streamflow", "update_block.transformer_block.transformer_block."),
    ("memfof", "update_block.aggregator.gamma"), ("llaflow", "lsa.gamma"),
    ("llaflow_raft", "s_lsa.to_f1.weight"),
    ("csflow", "strip_corr_block_v2.conv2_2.bn.running_var"),
    ("splatflow", "update.gru_sp.convq2.weight"),
    ("recover_mn", "cnet.features.4.block.2.fc1.weight"),
    ("recover_cx", "cnet.features.1.2.block.3.weight"),
    ("recover_rn", "cnet.layer2.0.downsample.1.weight"),
    ("flow_anything", "fnet.layer3.5.conv2.weight"),
    ("waft_twins_a2", "encoder.backbone.pos_block.3.proj.0.weight"),
    ("waft_dav2_a2", "encoder.encoder.cls_token"),
    ("waft_dav2_a1", "da_feature.depth_anything.pretrained.cls_token"),
    ("flowseek_t", "dav2.pretrained.pos_embed"),
    ("flowseek_m", "dav2.pretrained.pos_embed"),
    ("dip", "update_block_s.gru.convq.weight"),
    ("flow1d", "attn_x.self_attn.query_conv.weight"),
    ("gmflownet", "fnet.1.blocks.0.attn.relative_position_index"),
    ("gmflownet_mix", "fnet.1.blocks.0.localAttn.relative_position_index"),
    ("matchflow", "fnet.loftr_coarse.layers.7.attn.py_att.weight"),
    ("matchflow_raft", "fnet.backbone.layer3_outconv.weight"),
    ("scv4", "cnet.layer3.0.norm3.running_var"),
    ("scv8", "fnet.layer1.0.downsample.0.weight"),
    ("ms_raft_p", "fnet.layer2.0.downsample.1.weight"),
    ("ccmr", "update_block.aggregator.2.blocks.0.gamma3"),
    ("ccmr_p", "xcit.3.blocks.0.attn.temperature"),
    ("separableflow", "cost_agg1.deconv1b.conv1.conv.weight"),
    ("pwcnet", "dc_conv5.0.weight"), ("pwcnet_nodc", "upfeat3.weight"),
    ("irr_pwc", "occ_shuffle_upsample.res_convs.1.0.weight"),
    ("scopeflow", "refine_occ.convs.6.0.bias"),
    ("irr_pwcnet", "flow_estimators.4.conv_last.0.weight"),
    ("irr_pwcnet_irr", "conv_1x1.4.0.weight"),
    ("liteflownet", "matching_nets.4.up_corr.weight"),
    ("liteflownet2", "regularization_nets.3.dist.1.weight"),
    ("liteflownet2_pseudoreg", "pseudo_regularization.feat_net.0.weight"),
    ("liteflownet3", "modulation_nets.1.mod_scalar_net.2.weight"),
    ("liteflownet3_pseudoreg", "pseudo_subpixel.up_flow.weight"),
    ("liteflownet3s", "deformation_nets.0.up_conf.weight"),
    ("liteflownet3s_pseudoreg", "regularization_nets.0.conf_pred.0.weight"),
    ("fastflownet", "decoder6.conv4.0.weight"),
    ("maskflownet_s", "deform2.weight"),
    ("maskflownet", "MaskFlownet_S.deform5.bias"),
    ("hd3", "encoder.dla_up.ida_0.up_1.weight"),
    ("hd3_ctxt", "Decoder_4.dc_conv_5.1.running_var"),
    ("starflow", "conv_1x1_time.0.weight"),
    ("dicl", "dap_layer2.dap_layer.conv.weight"),
    ("vcn", "f2.conva1.conv1.conv2.0.weight"),
    ("vcn_small", "f3.proj.0.conv1.weight"),
    ("neuflow", "cross_attn_s16.norm.weight"),
    ("gmflow_refine", "backbone.trident_conv.weight"),
    ("unimatch", "upsampler.2.weight"), ("unimatch_sc2", "upsampler.0.bias"),
    ("unimatch_sc2_ref6", "refine.gru.convq2.weight")])
def test_reference_layout_checkpoint_loads(name, extra, tmp_path):
    """A Lightning-style .ckpt in the reference's layout, converted from a
    JAX tree (MemFlow nests its net under ``network.``, LCV-RAFT stores
    ``corr_block.eye``, RAPIDFlow its NeXt1D factors, RPKNet its layer
    scales, DPFlow the transposed convolution ``up_gru``, CRAFT its tied
    query under ``key.`` too, VideoFlow-MOF its initial motion state as
    (1, 1, 48, 1, 1), StreamFlow its temporal transformer, MEMFOF and
    LLA-Flow their ``gamma`` blends, CSFlow its strip block, SplatFlow its
    second GRU branch, ReCoVEr torchvision's MobileNetV3 and ConvNeXt
    names, ConvNeXt's ``layer_scale`` as (dim, 1, 1), WAFT's and
    FlowSeek's ViTs, DIP's small update block, Flow1D's 1-D attention,
    GMFlowNet's ``relative_position_index`` buffers, MatchFlow's quadtree
    level blend, the norm that SCV and MS-RAFT+ register twice (``norm3``
    and ``downsample.1``), CCMR's temperatures and layer scales,
    SeparableFlow's 3-D convolutions (a transposed one here) and
    BatchNorm3d, PWC-Net's transposed convolutions and dilated context,
    IRR's per-level and shared estimators and occlusion networks,
    LiteFlowNet's grouped transposed convolutions (the 49-group correlation
    upsampler, the 2-group flow upsamplers), separable distance heads,
    pseudo stages, deformation and modulation networks and confidence
    heads, FastFlowNet's grouped decoder convolutions, MaskFlowNet's
    deformable convolutions (torchvision's (O, C, k, k) weights) and its
    first stage nested under ``MaskFlownet_S.``, HD3's channel-wise IDA
    upsamplers and context head, STaRFlow's temporal 1x1 convolution,
    DICL's displacement-aware projections, VCN's separable 4-D
    convolutions as 5-D ``Conv3d`` weights ((O, I, 3, 3, 1) over the
    displacements, (O, I, 1, 3, 3) over the image, (O, I, 1, 1, 1)
    projections), NeuFlow's post-norm and affine-free BatchNorms,
    GMFlow's trident convolution, one (O, I, 3, 3) tensor shared by both
    scales), UniMatch's refinement (``refine_proj``, the update block's
    ``mask.0``/``mask.2``) or upsampler, loads into ``get_model`` strictly, every tensor equal.  WAFT's Twins checkpoint
    also holds timm's classifier ``norm.``/``head.``, which the load
    drops."""
    import jax

    from ptlflow_tpu_torch.utils.convert import state_dict_from_jax

    jmodel = ptlflow_tpu.get_model_reference(name)()
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    target = ptlflow_tpu_torch.get_model_reference(name)()
    # seeded uniform leaves (a third of the cost of normal ones at WAFT's
    # and FlowSeek's sizes): the layout is under test here, not the scale
    rng = np.random.default_rng(9)
    state = state_dict_from_jax(jax.tree_util.tree_map(
        lambda s: rng.random(s.shape, np.float32), shapes), target)
    assert any(k.startswith(extra) for k in state)
    timm = {f"encoder.backbone.{k}": torch.zeros(2)
            for k in ("norm.weight", "head.weight", "head_drop.p")
            if name == "waft_twins_a2"}
    path = tmp_path / f"{name}.ckpt"
    torch.save({"state_dict": dict(state, **timm,
                                   **{"loss_fn.x": torch.zeros(1)}),
                "hyper_parameters": {}}, path)
    model = ptlflow_tpu_torch.get_model(name, ckpt_path=str(path),
                                        device="cpu")
    for k, v in model.state_dict().items():
        assert v.dtype == state[k].dtype and torch.equal(v, state[k]), k


@pytest.mark.parametrize("name,extra,args", [
    ("flownets", "upsampled_flow6_to_5.weight", {}),
    ("flownetc", "conv_redir.0.weight", {}),
    ("flownetsd", "inter_conv2.0.weight", {}),
    ("flownetcs", "flownets_1.conv1.0.weight", {}),
    ("flownetcss", "flownets_2.predict_flow2.bias", {}),
    ("flownet2", "flownetfusion.inter_conv0.0.weight", {}),
    ("flownet2", "flownets_d.inter_conv2.1.running_var",
     {"batch_norm": True}),
    ("maskflownet_s", "conv2f.0.weight", {}),
    ("maskflownet", "MaskFlownet_S.pred_mask3.weight", {}),
    ("hd3", "encoder.base.level4.tree2.root.bn.running_mean", {}),
    ("hd3_ctxt", "Decoder_4.cls.weight", {}),
    ("hd3", "encoder.block_5.conv3.weight", {"encoder": "vgg"}),
    ("hd3", "Decoder_3.mapping.block1.shortcut.0.weight",
     {"decoder": "resnet"}),
    ("starflow", "refine_occ.convs.6.0.weight", {}),
    ("dicl", "matching4.match.4.conv.weight", {}),
    ("vcn", "p2.conv2.weight", {}),
    ("vcn_small", "dc3_convo.6.weight", {}),
    ("neuflow", "backbone.block1_dd.conv_block.norm.running_var", {}),
    ("gmflow_refine", "backbone.trident_conv.weight", {}),
    ("gmflow", "transformer.layers.5.cross_attn_ffn.mlp.2.weight", {}),
    ("unimatch", "upsampler.0.weight", {}),
    ("unimatch_sc2", "backbone.trident_conv.weight", {}),
    ("unimatch_sc2_ref6", "refine.mask.2.bias", {})])
def test_reference_layout_loads_at_registered_width(name, extra, args):
    """FlowNet's six names at their registered width (39 to 163 million
    parameters), and ``flownet2`` with ``batch_norm`` (every convolution
    without its bias, a BatchNorm after it): the JAX tree's every leaf, as
    zeros of its shape, converted by ``state_dict_from_jax`` holds the
    names and shapes of the port's ``state_dict`` (the sub-networks
    ``flownetc.``, ``flownets_1.``, ``flownets_2.``, ``flownets_d.`` and
    ``flownetfusion.`` of the reference's checkpoints among them) and loads
    strictly into the model built on the meta device.  The parity tests
    hold the values; a checkpoint file of ``flownet2`` would be 650 MB.
    Likewise the slice of MaskFlowNet (+S), HD3 (+ctxt, and the
    ``encoder="vgg"`` and ``decoder="resnet"`` options that no registered
    name sets), STaRFlow and DICL; VCN (+small), NeuFlow and GMFlow
    (+refine); and UniMatch's three architectures."""
    import jax

    from ptlflow_tpu_torch.utils.convert import state_dict_from_jax

    jmodel = ptlflow_tpu.get_model_reference(name)(**args)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                   shapes)
    with torch.device("meta"):
        target = ptlflow_tpu_torch.get_model_reference(name)(**args)
    state = state_dict_from_jax(zeros, target)
    assert any(k.startswith(extra) for k in state)
    assert {k: v.shape for k, v in state.items()} == {
        k: v.shape for k, v in target.state_dict().items()}
    target.load_state_dict(state, strict=True, assign=True)
    assert all(p.device.type == "cpu" for p in target.parameters())


def test_named_checkpoint_needs_the_cache(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.hub, "get_dir", lambda: str(tmp_path))
    model = ptlflow_tpu_torch.get_model_reference("raft_small")()
    with pytest.raises(FileNotFoundError, match="downloads nothing"):
        tckpt.restore_model(model, "things")
    cached = tmp_path / "checkpoints" / "raft_small-things-b7d9f997.ckpt"
    cached.parent.mkdir()
    torch.save(model.state_dict(), cached)
    assert tckpt.resolve_checkpoint_path(model, "things") == str(cached)
    with pytest.raises(ValueError):
        tckpt.resolve_checkpoint_path(model, "no_such_checkpoint")


@pytest.mark.parametrize("target_size", [None, (48, 64)])
def test_io_adapter_matches_jax(target_size):
    rng = np.random.RandomState(8)
    frames = [rng.randint(0, 256, (37, 51, 3), dtype=np.uint8)
              for _ in range(2)]
    jad = JIOAdapter(output_stride=8, target_size=target_size)
    tad = IOAdapter(output_stride=8, target_size=target_size, device="cpu")
    want = np.asarray(jad.prepare_inputs(frames)["images"])
    got = tad.prepare_inputs(frames)["images"]
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)

    flows = rng.randn(1, 1, 2, *got.shape[-2:]).astype(np.float32)
    want_u = np.asarray(jad.unscale({"flows": jnp.asarray(flows)})["flows"])
    got_u = tad.unscale({"flows": torch.from_numpy(flows)})["flows"]
    assert got_u.shape[-2:] == (37, 51) or target_size is None
    np.testing.assert_allclose(got_u.numpy(), want_u, atol=1e-4)


def test_io_adapter_feeds_the_model():
    model = ptlflow_tpu_torch.get_model("raft_small", args={"iters": 1},
                                        device="cpu")
    rng = np.random.RandomState(9)
    frames = [rng.rand(61, 83, 3).astype(np.float32) for _ in range(2)]
    adapter = IOAdapter(model)
    inputs = adapter.prepare_inputs(frames)
    assert inputs["images"].device == model.device
    out = adapter.unscale(model(inputs))
    assert out["flows"].shape == (1, 1, 2, 61, 83)
