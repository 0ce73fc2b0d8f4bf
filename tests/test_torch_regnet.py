"""The port's RegNet backbones and PointPillars' bf16 dense stack against
gga_tpu's, CPU.

- ``generate_regnet``: the stage widths, depths and group widths of the
  four archs equal gga_tpu's.
- ``convert.regnet_rules`` equal ``torch2flax.export_regnet`` key for key
  and value for value (each arch, gga_tpu's variables drawn with numpy).
- ``NoStemRegNet('regnetx_400mf')`` on a [2, 64, 32, 32] canvas, its
  weights through the port's converter: in train mode (batch
  statistics) each X-block on gga_tpu's input to it and the BN running
  statistics the pass leaves, then the whole backbone in eval mode on
  those statistics, within 1e-5 of the largest value.
- A tiny PointPillars in bf16 (``compute_dtype='bfloat16'``, the module
  itself: the builder and the entry points refuse the bf16 configs, whose
  whole step missed the bf16 gates on the card) with each of the three
  structures of the _fp16_ configs (SECOND + SECONDFPN, SECOND + FPN,
  RegNet-400MF + FPN): the head's maps of an eval-mode forward against
  gga_tpu's bf16 forward. Both cast the canvas to bf16 and run
  the backbone's convs in bf16 with f32 accumulation (cuDNN / oneDNN on
  the port's side, XLA's on gga_tpu's), each rounding its outputs to bf16,
  so the maps part by a few bf16 ulps of the activations: the tolerance
  is 3e-2 of the largest |map| value (about 8 ulps of 2^-8; measured
  0.57-1.57 %, where gga_tpu's bf16 forward parts from its own f32 one by
  0.51-1.08 %), and the f32 forward of the same weights agrees within
  1e-5.

gga_tpu's variables come from ``jax.eval_shape`` of its init with numpy
values; each JAX reference is jitted once.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from gga_tpu.models.backbones import regnet as jregnet
from gga_tpu.models.dense_heads.anchor3d_head import Anchor3DConfig as JHead
from gga_tpu.models.detectors import voxelnet as jvn
from gga_tpu_torch import apis, convert
from gga_tpu_torch.models.backbones import regnet as tregnet
from gga_tpu_torch.models.dense_heads.anchor3d_head import \
    Anchor3DConfig as THead
from gga_tpu_torch.models.detectors import voxelnet as tvn
from tools.model_converters import torch2flax

from .test_torch_supervised import _fill

torch.set_num_threads(1)

ARCHS = tuple(jregnet.REGNET_ARCHS)
BF16_TOL = 3e-2          # of max |map|: bf16 activations, see the docstring
RANGE = (-16.0, -16.0, -5.0, 16.0, 16.0, 3.0)
HEAD = dict(num_classes=2, feat_channels=48, nms_pre=32, max_num=16,
            anchor_ranges=((-16, -16, -1.8, 16, 16, -1.8),) * 2,
            anchor_sizes=((4.6, 1.9, 1.7), (0.7, 0.7, 1.8)),
            pos_iou_thr=(0.6, 0.5), neg_iou_thr=(0.45, 0.35),
            min_pos_iou=(0.45, 0.35))
# the tiny pillar net of every structure: 0.5 m pillars on 64 x 64
TINY = dict(voxel_size=(0.5, 0.5, 8.0), point_cloud_range=RANGE,
            max_points_per_voxel=16, max_voxels=1024, pfn_channels=(16,),
            scatter_shape=(64, 64), backbone_channels=(16, 32, 32),
            backbone_layers=(1, 1, 1), neck_channels=(16, 16, 16))
STRUCTURES = {'second_secfpn': dict(),
              'second_fpn': dict(neck='fpn'),
              'regnet_fpn': dict(backbone='regnetx_400mf', neck='fpn')}


def pillar_configs(cls_j, cls_t, head_j, head_t, **fields):
    """gga_tpu's and the port's config of the tiny pillar net."""
    kw = dict(TINY, **fields)
    return cls_j(head=head_j, **kw), cls_t(head=head_t, **kw)


def cloud(seed, B=2, P=3000, boxes=()):
    """B scenes of P points in RANGE, 5 features (x, y, z, intensity, a
    time lag), clusters of points inside the given boxes."""
    rng = np.random.RandomState(seed)
    pts = np.concatenate([rng.uniform(RANGE[:3], RANGE[3:], (B, P, 3)),
                          rng.uniform(0, 1, (B, P, 2))], -1)
    pts[..., 2] = rng.uniform(-2.0, 0.5, (B, P))
    for b in range(B):
        for k, box in enumerate(boxes):
            n = 150
            sl = slice(k * n, (k + 1) * n)
            pts[b, sl, :3] = box[:3] + rng.uniform(-0.5, 0.5, (n, 3)) \
                * np.asarray(box[3:6]) + [0, 0, box[5] / 2]
    return pts.astype(np.float32), np.ones((B, P), bool)


@pytest.mark.parametrize('arch', ARCHS)
def test_generate_regnet_equals_gga_tpu(arch):
    a = jregnet.REGNET_ARCHS[arch]
    assert tregnet.REGNET_ARCHS[arch] == a
    ref = jregnet.generate_regnet(a['w0'], a['wa'], a['wm'], a['depth'],
                                  a['group_w'])
    assert tregnet.generate_regnet(**tregnet.REGNET_ARCHS[arch]) == ref
    assert tregnet.NoStemRegNet(arch).out_channels == \
        jregnet.NoStemRegNet.stage_widths(arch)[1:]
    # every stage's width splits into whole groups
    assert all(w % g == 0 for w, g in zip(ref[0], ref[2]))


def _regnet_variables(arch, seed, shape=(1, 16, 16, 64)):
    model = jregnet.NoStemRegNet(arch=arch)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), np.zeros(shape, np.float32), train=False))
    return model, _fill({c: shapes[c] for c in ('params', 'batch_stats')},
                        np.random.RandomState(seed))


@pytest.mark.parametrize('arch', ARCHS)
def test_regnet_rules_equal_export_regnet(arch):
    _, variables = _regnet_variables(arch, 0)
    ref = torch2flax.export_regnet(variables, dict(arch=arch))
    out = convert.convert_with_rules(
        variables, convert.regnet_rules(arch, flax_prefix=''))
    assert list(out) == list(ref)
    for key, v in ref.items():
        assert out[key].dtype == torch.float32
        np.testing.assert_array_equal(out[key].numpy(), v, err_msg=key)
    # the port's backbone takes them strictly
    backbone = tregnet.NoStemRegNet(arch)
    backbone.load_state_dict({k[len('backbone.'):]: v
                              for k, v in out.items()})


@pytest.fixture(scope='module')
def regnet_pass():
    """gga_tpu's NoStemRegNet-400MF on a [2, 32, 32, 64] canvas: the
    train-mode stages, every X-block's output and the statistics they
    leave, then eval mode on those statistics (one jit)."""
    model, variables = _regnet_variables('regnetx_400mf', 1)
    x = np.random.RandomState(2).normal(0, 1, (2, 32, 32, 64)).astype(
        np.float32)

    @jax.jit
    def run(v, x):
        outs, mut = model.apply(
            v, x, train=True, mutable=['batch_stats', 'intermediates'],
            capture_intermediates=lambda m, _: isinstance(
                m, jregnet.RegNetXBlock))
        evals = model.apply({'params': v['params'],
                             'batch_stats': mut['batch_stats']}, x,
                            train=False)
        return outs, mut, evals

    outs, mut, evals = jax.tree_util.tree_map(np.asarray,
                                              run(variables, x))
    inter = mut['intermediates']
    blocks = [inter[f'RegNetXBlock_{k}']['__call__'][0]
              for k in range(len(inter))]
    return variables, x, outs, blocks, mut['batch_stats'], evals


def _port_regnet(variables):
    sd = convert.convert_with_rules(
        variables, convert.regnet_rules('regnetx_400mf', flax_prefix=''))
    backbone = tregnet.NoStemRegNet('regnetx_400mf', 64)
    backbone.load_state_dict({k[len('backbone.'):]: v for k, v in sd.items()})
    return backbone


def _close(out, ref, tol, what):
    ref = np.asarray(ref)
    err = float(np.abs(out - ref).max())
    assert err <= tol * float(np.abs(ref).max()), (what, err)


def _nchw(x):
    return torch.from_numpy(np.array(x)).permute(0, 3, 1, 2)


def test_no_stem_regnet_train_mode_matches_gga_tpu(regnet_pass):
    """Each X-block in train mode on gga_tpu's input to it, and the
    running statistics the pass leaves, within 1e-5. (Chained through the
    22 blocks, train-mode BN over 32 values a channel at stage 3 amplifies
    f32 rounding: against a float64 evaluation of the same weights the
    port's stage 3 reads 5.2e-5 of max and gga_tpu's 1.5e-4, so the chain
    is compared in eval mode below.)"""
    variables, x, outs, blocks, stats, _ = regnet_pass
    backbone = _port_regnet(variables).train()
    ports = [b for i in range(4) for b in getattr(backbone, f'layer{i + 1}')]
    assert len(ports) == len(blocks) == 22
    h = x
    with torch.no_grad():
        for k, (blk, ref) in enumerate(zip(ports, blocks)):
            _close(blk(_nchw(h)).permute(0, 2, 3, 1).numpy(), ref, 1e-5,
                   f'block {k}')
            h = ref
    # the stages gga_tpu returns are its stage-1..3 last blocks' outputs
    for out, k in zip(outs, (2, 9, 21)):
        np.testing.assert_array_equal(out, blocks[k])
    ref_stats = convert.convert_with_rules(
        {'batch_stats': stats},
        convert.regnet_rules('regnetx_400mf', flax_prefix=''))
    sd = backbone.state_dict()
    assert len(ref_stats) == 2 * sum(k.endswith('.running_mean')
                                     for k in sd)
    for key, r in ref_stats.items():
        _close(sd[key[len('backbone.'):]].numpy(), r.numpy(), 1e-5, key)


def test_no_stem_regnet_eval_mode_matches_gga_tpu(regnet_pass):
    """The whole backbone in eval mode on the statistics of gga_tpu's
    train pass, each returned stage within 1e-5."""
    variables, x, _, _, stats, evals = regnet_pass
    backbone = _port_regnet({'params': variables['params'],
                             'batch_stats': stats}).eval()
    with torch.no_grad():
        got = backbone(_nchw(x))
    assert [tuple(g.shape[1:]) for g in got] == [
        (64, 16, 16), (160, 8, 8), (384, 4, 4)]
    for g, r in zip(got, evals):
        _close(g.permute(0, 2, 3, 1).numpy(), r, 1e-5, 'stage')


@pytest.fixture(scope='module', params=list(STRUCTURES))
def bf16_pass(request):
    """Each structure's tiny PointPillars: gga_tpu's eval forward in f32
    and in bf16 (one jit), and the port's on the same weights."""
    fields = STRUCTURES[request.param]
    jcfg, tcfg = pillar_configs(jvn.PointPillarsConfig,
                                tvn.PointPillarsConfig, JHead(**HEAD),
                                THead(**HEAD), **fields)
    pts, valid = cloud(3, boxes=[(4.0, 2.0, -1.8, 4.6, 1.9, 1.7)])
    models = [jvn.PointPillars(dataclasses.replace(jcfg, compute_dtype=d))
              for d in ('float32', 'bfloat16')]
    shapes = jax.eval_shape(lambda: models[0].init(
        jax.random.PRNGKey(0), pts[:1, :, :4], valid[:1], train=False))
    variables = _fill({c: shapes[c] for c in ('params', 'batch_stats')},
                      np.random.RandomState(4))

    @jax.jit
    def run(v, p, m):
        return [model.apply(v, p, m, train=False) for model in models]

    ref32, ref16 = jax.tree_util.tree_map(
        np.asarray, run(variables, pts[..., :4], valid))
    sd = convert.from_jax_variables(variables, tcfg)
    out = {}
    for dtype in ('float32', 'bfloat16'):
        # the module, as the builder and the entry points refuse the bf16
        # configs (test_bf16_pillars_are_refused)
        model = tvn.PointPillars(dataclasses.replace(tcfg,
                                                     compute_dtype=dtype))
        model.load_state_dict(sd)
        with torch.no_grad():
            # the port reads the first four of the five point features
            out[dtype] = model.eval()(torch.from_numpy(pts),
                                      torch.from_numpy(valid))
    return dict(ref32=ref32, ref16=ref16, out=out, model=model, tcfg=tcfg,
                sd=sd)


def test_pointpillars_bf16_forward_matches_gga_tpu(bf16_pass):
    out, ref16, ref32 = bf16_pass['out'], bf16_pass['ref16'], \
        bf16_pass['ref32']
    for key in ('cls', 'reg', 'dir'):
        assert out['bfloat16'][key].dtype == torch.float32
        assert ref16[key].dtype == np.float32
        _close(out['float32'][key].numpy(), ref32[key], 1e-5, key)
        _close(out['bfloat16'][key].numpy(), ref16[key], BF16_TOL, key)
        # bf16 moved the maps: the comparison is of two bf16 forwards
        assert np.abs(ref16[key] - ref32[key]).max() > 0


def test_pointpillars_bf16_runs_the_dense_stack_in_bf16(bf16_pass):
    """The backbone's (and SECONDFPN's) outputs are bf16, FPN's and the
    head's f32, as flax's promotion gives them in gga_tpu."""
    model = bf16_pass['model']
    pts, valid = cloud(3, B=1)
    bev = model.extract_bev(torch.from_numpy(pts), torch.from_numpy(valid))
    assert bev.dtype == torch.bfloat16
    with torch.no_grad():
        xs = model.backbone(bev)
        fused = model.fused(bev)
    assert all(x.dtype == torch.bfloat16 for x in xs)
    assert fused.dtype == (torch.float32 if model.fpn else torch.bfloat16)
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_bf16_pillars_are_refused(bf16_pass):
    """The entry points refuse a bf16 PointPillars config, citing the
    card's measured gate; its f32 twin loads the same weights."""
    cfg = dataclasses.replace(bf16_pass['tcfg'], compute_dtype='bfloat16')
    with pytest.raises(NotImplementedError,
                       match='_fp16_ PointPillars.*cosine floor 0.97'):
        apis.init_anchor_detector(cfg, bf16_pass['sd'], device='cpu')
    apis.init_anchor_detector(bf16_pass['tcfg'], bf16_pass['sd'],
                              device='cpu')
