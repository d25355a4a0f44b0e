"""The kernel ablations of scripts/torch_kernel_ablation.py patch the CUDA
sources by exact text; each patch must still find its text in
emap_tpu_torch/csrc. No build: the card runs the script itself."""

import importlib.util
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "torch_kernel_ablation",
    os.path.join(ROOT, "scripts", "torch_kernel_ablation.py"))
ablation = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ablation)


@pytest.mark.parametrize("name", sorted(ablation.ABLATIONS))
def test_ablation_patches_apply(tmp_path, name):
    tree = ablation.patched_tree(str(tmp_path), name)
    for fn, edits in ablation.ABLATIONS[name].items():
        with open(os.path.join(tree, fn)) as f:
            src = f.read()
        for _, new in edits:
            assert new in src
