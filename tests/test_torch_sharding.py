"""Port parity, the sharding plan: ``model_pspec``, ``cache_pspec`` and
``input_pspecs`` of all 11 configs on the single-pod and multi-pod
meshes, ``fsdp_pspec`` and ``zero1_state_pspec`` on the reduced
configs, ``shape_plan``'s variants and notes, and the meta shapes of
``input_specs``, each equal to the JAX reference's entry by entry (a
spec as the tuple of its entries, a leaf by its tree path).  The
reference's specs come from its own functions on its own ``Axes``,
which its ``axes_for`` builds from the port's shape-only mesh; its
shapes from ``jax.eval_shape``, once a module.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import (ARCH_IDS as REF_ARCH_IDS,  # noqa: E402
                           SHAPES as REF_SHAPES,
                           get_config as ref_get_config,
                           input_pspecs as ref_input_pspecs,
                           input_specs as ref_input_specs,
                           shape_plan as ref_shape_plan)
from repro.launch.mesh import axes_for as ref_axes_for  # noqa: E402
from repro.models.transformer import (cache_pspec as ref_cache_pspec,  # noqa: E402
                                      fsdp_pspec as ref_fsdp_pspec,
                                      model_init as ref_model_init,
                                      model_pspec as ref_model_pspec)
from repro.optim.adamw import (  # noqa: E402
    adamw_state_pspec as ref_adamw_state_pspec,
    zero1_state_pspec as ref_zero1_state_pspec)

from repro_torch.configs import (ARCH_IDS, SHAPES, SWEEP_IDS,  # noqa: E402
                                 get_config, input_pspecs, input_specs,
                                 shape_plan)
from repro_torch.launch.mesh import (H100_SXM, axes_for,  # noqa: E402
                                     device_mesh, make_production_mesh)
from repro_torch.models.common import PSpec  # noqa: E402
from repro_torch.models.transformer import (cache_pspec,  # noqa: E402
                                            fsdp_pspec, model_init,
                                            model_pspec)
from repro_torch.optim.adamw import (adamw_state_pspec,  # noqa: E402
                                     zero1_state_pspec)

MESHES = {"16x16": make_production_mesh(),
          "2x16x16": make_production_mesh(multi_pod=True)}


def flat(tree, path=()):
    """[(path, leaf)] of a spec or shape tree, dict keys sorted; a spec
    leaf as the tuple of its entries."""
    if isinstance(tree, (P, PSpec)):
        return [(path, tuple(tree))]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flat(tree[k], path + (k,))]
    if isinstance(tree, (tuple, list)):
        return [x for i, v in enumerate(tree) for x in flat(v, path + (i,))]
    return [(path, tree)]


def shapes(tree):
    """[(path, shape, dtype name)] of a tree of meta tensors or
    ShapeDtypeStructs."""
    out = []
    for path, leaf in flat(tree):
        dt = (str(leaf.dtype).split(".")[-1]
              if isinstance(leaf, torch.Tensor) else np.dtype(leaf.dtype).name)
        out.append((path, tuple(leaf.shape), dt))
    return out


@pytest.fixture(scope="module")
def ref_shapes():
    """The reference's param shapes of every reduced config."""
    return {a: jax.eval_shape(
        lambda k, a=a: ref_model_init(ref_get_config(a).reduced(), k),
        jax.random.PRNGKey(0)) for a in ARCH_IDS}


def test_mesh_shapes_and_axes_equal_reference():
    assert MESHES["16x16"].shape == {"data": 16, "model": 16}
    assert MESHES["2x16x16"].shape == {"pod": 2, "data": 16, "model": 16}
    for name, mesh in MESHES.items():
        assert mesh.name == name
        ours, ref = axes_for(mesh), ref_axes_for(mesh)
        assert (ours.data, ours.model, ours.model_size, ours.extra_data,
                ours.data_axes) == (ref.data, ref.model, ref.model_size,
                                    ref.extra_data, ref.data_axes)
    assert (H100_SXM.peak_flops, H100_SXM.hbm_bw, H100_SXM.link_bw,
            H100_SXM.hbm_bytes, H100_SXM.inter_node_bw,
            H100_SXM.node_size) == (989e12, 3.35e12, 450e9, 80e9, 50e9, 8)
    with pytest.raises(RuntimeError):       # no process group here
        device_mesh(MESHES["16x16"])
    assert SWEEP_IDS == REF_ARCH_IDS


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_cache_input_pspecs_equal_reference(arch, mesh):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    axes, ref_axes = axes_for(MESHES[mesh]), ref_axes_for(MESHES[mesh])
    assert flat(model_pspec(cfg, axes)) == flat(ref_model_pspec(ref_cfg,
                                                                ref_axes))
    assert flat(cache_pspec(cfg, axes)) == flat(ref_cache_pspec(ref_cfg,
                                                                ref_axes))
    assert flat(adamw_state_pspec(model_pspec(cfg, axes))) == flat(
        ref_adamw_state_pspec(ref_model_pspec(ref_cfg, ref_axes)))
    for shape in SHAPES:
        c, note = shape_plan(cfg, shape)
        rc, ref_note = ref_shape_plan(ref_cfg, shape)
        assert note == ref_note
        if c is None:
            assert rc is None
            continue
        assert (c.name, c.layer_kinds, c.sliding_window) == (
            rc.name, rc.layer_kinds, rc.sliding_window)
        assert flat(input_pspecs(c, shape, axes)) == flat(
            ref_input_pspecs(rc, shape, ref_axes))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_fsdp_and_zero1_pspecs_equal_reference(arch, ref_shapes):
    cfg, ref_cfg = get_config(arch).reduced(), ref_get_config(arch).reduced()
    meta = model_init(cfg, None, device="meta")
    assert shapes(meta) == shapes(ref_shapes[arch])
    for mesh in MESHES.values():
        axes, ref_axes = axes_for(mesh), ref_axes_for(mesh)
        degree = mesh.size // mesh.shape["model"]
        ours = fsdp_pspec(cfg, axes, data_degree=degree)
        assert flat(ours) == flat(ref_fsdp_pspec(ref_cfg, ref_axes,
                                                 data_degree=degree))
        for base, ref_base in ((model_pspec(cfg, axes),
                                ref_model_pspec(ref_cfg, ref_axes)),
                               (ours, ref_fsdp_pspec(ref_cfg, ref_axes,
                                                     data_degree=degree))):
            assert flat(zero1_state_pspec(base, meta, axes)) == flat(
                ref_zero1_state_pspec(ref_base, ref_shapes[arch], ref_axes))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_meta_shapes_equal_reference(arch):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    for shape in REF_SHAPES:
        c, _ = shape_plan(cfg, shape)
        if c is None:
            continue
        rc, _ = ref_shape_plan(ref_cfg, shape)
        ours = input_specs(c, shape)
        assert all(t.device.type == "meta" for _, t in flat(ours))
        assert shapes(ours) == shapes(ref_input_specs(rc, shape))


def test_meta_init_draws_nothing_and_needs_no_generator_there():
    cfg = get_config("deepseek-v3-671b")
    params = model_init(cfg, None, device="meta")
    n = sum(t.numel() for _, t in flat(params))
    assert n == 671_026_404_352
    with pytest.raises(ValueError):
        model_init(cfg.reduced(), None, device="cpu")
