"""sesa_tpu_torch imports neither JAX nor anything of the JAX package."""

import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "sesa_tpu_torch")


def test_every_module_imports_with_jax_blocked():
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "import sesa_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(sesa_tpu_torch.__path__,"
        " 'sesa_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m == 'sesa_tpu' or m.startswith('sesa_tpu.')]\n"
        "assert not bad, bad\n"
        "print(' '.join(names))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    names = set(r.stdout.split())
    assert len(names) >= 35
    assert {f"sesa_tpu_torch.{m}" for m in (
        "ops.mel", "ops.convblock", "models.conformer_core", "models.mel_band_roformer",
        "models.mel_band_conformer", "models.apollo", "postprocess", "postprocess.ensemble",
        "postprocess.phase_fixer", "apollo_processing", "audio_io", "ops.ssd",
        "models.hyper_connections", "models.bs_roformer_experimental",
        "models.mel_band_roformer_experimental", "models.bs_mamba2", "ops.fft",
        "models.conformer", "models.bs_roformer_custom", "models.scnet", "models.scnet_tran",
        "models.scnet_masked", "models.scnet_unofficial", "models.mdx23c",
        "models.mdx23c_stht", "models.htdemucs", "models.demucs_legacy", "ops.wiener",
        "models.bandit", "models.bandit_v2", "models.resnet_unet", "models.efficientnet_unet",
        "models.maxvit_unet", "models.segm_models", "models.swin_upernet", "models.squim",
        "metrics", "convert.lora", "utils", "cache", "clean_model",
        "config_manager", "helpers", "download", "registry", "registry.models", "processing",
        "runtime.profiling", "benchmark", "warmup", "losses", "train", "data",
        "data.augmentation", "data.datasets", "i18n", "gui", "main")} <= names


def test_training_and_ui_import_with_jax_and_the_jax_package_blocked():
    """The training and UI layers run where neither JAX, the JAX package,
    optax nor gradio imports; the launcher parses its arguments there."""
    code = (
        "import sys\n"
        "for m in ('jax', 'sesa_tpu', 'optax', 'gradio', 'ml_collections'):\n"
        "    sys.modules[m] = None\n"
        "import sesa_tpu_torch.train, sesa_tpu_torch.losses, sesa_tpu_torch.data\n"
        "import sesa_tpu_torch.gui as gui, sesa_tpu_torch.main as main\n"
        "assert not gui.GRADIO_AVAILABLE\n"
        "t = sesa_tpu_torch.train.parse_optimizer_config({'optimizer': {'name': 'RAdam'}})\n"
        "assert t.schedule(0) == 1e-3\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'sesa_tpu', 'optax')\n"
        "       and sys.modules[m] is not None]\n"
        "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_app_modules_import_without_yaml_and_requests():
    """A GPU host may have neither pyyaml nor requests: the app layer
    imports them only inside the functions that need them."""
    code = (
        "import sys\n"
        "for m in ('jax', 'yaml', 'requests'): sys.modules[m] = None\n"
        "import sesa_tpu_torch.processing, sesa_tpu_torch.registry, sesa_tpu_torch.benchmark\n"
        "import sesa_tpu_torch.warmup, sesa_tpu_torch.download, sesa_tpu_torch.apollo_processing\n"
        "from sesa_tpu_torch.registry import MODEL_CONFIGS\n"
        "assert sum(len(c) for c in MODEL_CONFIGS.values()) >= 120\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_sources_name_no_jax_package():
    pattern = re.compile(r"^\s*(from|import)\s+(jax|sesa_tpu)(\.|\s|$)", re.M)
    offenders = []
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(root, f)
                with open(path) as fh:
                    if pattern.search(fh.read()):
                        offenders.append(os.path.relpath(path, REPO))
    assert not offenders, offenders


def test_chip_smoke_names_no_jax_package():
    with open(os.path.join(REPO, "chip_smoke.py")) as fh:
        src = fh.read()
    assert not re.search(r"^\s*(from|import)\s+(jax|sesa_tpu)(\.|\s|$)", src, re.M)
