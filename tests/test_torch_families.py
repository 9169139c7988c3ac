"""The port's table of model families (`models.families`) and the direction
of its imports.

  * Each family's entry gives what `build_model` returns for it (spec, apply
    function, latent size, cross width) and the defaults the CLIs and the
    pipelines give it: sampler steps (25 SD, 4 SDXL-turbo, 28 SD3), the
    calibration batch (8, 4; SD3 has no calibration path), the image size
    (512, 1024, 1024).
  * No module under pipeline/, models/, ops/ or quant/ imports
    `dgq_tpu_torch.cli`, at the top or inside a function.
"""
import ast
import inspect
import os

import pytest

from dgq_tpu_torch.cli import quantize_act, quantize_weight
from dgq_tpu_torch.models.families import CLI_FAMILIES, FAMILIES, build_model
from dgq_tpu_torch.models.mmdit_sd3 import mmdit_sd3_apply, mmdit_sd3_spec
from dgq_tpu_torch.models.unet_sd import sd_unet_spec, unet_sd_apply
from dgq_tpu_torch.models.unet_sdxl import sdxl_unet_spec, unet_sdxl_apply
from dgq_tpu_torch.pipeline.sd_pipeline import SD3Pipeline, SDPipeline, SDXLTurboPipeline

PACKAGE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "dgq_tpu_torch")

# family: (steps, calibration batch, image px, latent hw, latent channels, cross width,
# spec, apply, pipeline)
FACTS = {
    "sd": (25, 8, 512, 64, 4, 768, lambda: sd_unet_spec(base=32), unet_sd_apply, SDPipeline),
    "sdxl": (4, 4, 1024, 128, 4, 2048, lambda: sdxl_unet_spec(base=32, depths=(1, 1)),
             unet_sdxl_apply, SDXLTurboPipeline),
    "sd3": (28, None, 1024, 128, 16, 4096, mmdit_sd3_spec, mmdit_sd3_apply, SD3Pipeline),
}


@pytest.mark.parametrize("name", sorted(FACTS))
def test_family_entry_gives_build_model_and_the_defaults(name):
    steps, batch, px, hw, channels, cross, spec_of, apply, pipeline = FACTS[name]
    fam = FAMILIES[name]
    assert (fam.steps, fam.cali_batch, fam.image_size) == (steps, batch, px)
    assert (fam.latent_hw, fam.latent_channels, fam.cross) == (hw, channels, cross)
    base = None if name == "sd3" else 32
    spec, params, apply_fn, latent_hw, cross_w = build_model(
        name, base=base, sdxl_depths=(1, 1), init_params=False, device="cpu")
    assert spec == spec_of() and params is None
    assert apply_fn is apply and (latent_hw, cross_w) == (hw, cross)
    # the pipeline's own defaults are the table's
    defaults = inspect.signature(pipeline.generate_from_embeddings).parameters
    assert defaults["steps"].default == steps
    assert defaults["height"].default == defaults["width"].default == px
    if name in CLI_FAMILIES:
        params = build_model(name, base=32, sdxl_depths=(1, 1), device="cpu")[1]
        assert set(params) == {n for n, _, _ in spec}
        for cli in (quantize_weight, quantize_act):
            argv = ["--model", name] + (["--cali_ckpt", "w"] if cli is quantize_act else [])
            assert cli.parse_args(argv).step_size == steps


def _imports(path):
    """Every module a source file imports, at the top or inside a function."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
            yield from (f"{node.module}.{a.name}" for a in node.names)


def test_no_lower_layer_imports_the_cli():
    found = []
    for layer in ("pipeline", "models", "ops", "quant"):
        root = os.path.join(PACKAGE, layer)
        for f in sorted(os.listdir(root)):
            if f.endswith(".py"):
                found += [(layer, f, m) for m in _imports(os.path.join(root, f))
                          if m == "dgq_tpu_torch.cli" or m.startswith("dgq_tpu_torch.cli.")]
    assert not found
