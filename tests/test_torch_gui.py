"""The port's UI layer: i18n, the gradio UI's pure helpers and wiring, and
the launcher, held to tests/test_app_layer.py's cases and to the JAX
package's tables and arguments. Neither machine needs gradio: without it
the module imports and ``create_interface`` raises."""

import ast
import json
import os
import re
import subprocess
import sys

import pytest

import sesa_tpu.i18n as jax_i18n
import sesa_tpu.main as jax_main
from sesa_tpu_torch import gui, i18n, main, processing
from sesa_tpu_torch.i18n import I18nAuto

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _gui_source():
    with open(gui.__file__, encoding="utf-8") as f:
        return f.read()


def _table(module, name="en_us"):
    with open(os.path.join(module.LANGUAGE_PATH, f"{name}.json"), encoding="utf-8") as f:
        return json.load(f)


def test_language_tables_equal_the_jax_packages():
    names = I18nAuto.available_languages()
    assert names == jax_i18n.I18nAuto.available_languages() and len(names) >= 11
    for name in names:
        assert _table(i18n, name) == _table(jax_i18n, name), name
    assert os.path.dirname(i18n.LANGUAGE_PATH) != os.path.dirname(jax_i18n.LANGUAGE_PATH)


def test_i18n_loads_and_translates():
    t = I18nAuto(language="en_US")
    assert t("total_files_found")
    assert t("__missing_key__") == "__missing_key__"
    assert I18nAuto(language="zh_CN").language == "zn_cn"
    assert I18nAuto(language="xx_XX").language == "en_us"


def test_gui_language_switch_changes_strings():
    en, tr = I18nAuto(language="en_US"), I18nAuto(language="tr_TR")
    changed = sum(en(k) != tr(k) for k in
                  ("audio_separation_tab", "process", "chunk_size", "overlap", "output_format"))
    assert changed >= 3


def test_gui_import_without_gradio():
    if not gui.GRADIO_AVAILABLE:
        with pytest.raises(RuntimeError, match=r"python -m sesa_tpu_torch\.cli"):
            gui.create_interface()
    assert "progress-fill" in gui.progress_html(50)
    assert "&lt;class" in gui.progress_html(150, "<class 'x'>")


def test_gui_wires_all_16_stem_slots():
    slot_names = [name for name, _ in gui.STEM_LABELS]
    assert sorted(slot_names) == sorted(processing.STEM_SLOTS) and len(slot_names) == 16
    outs = gui.slot_outputs({"slots": {"male": "m.wav", "karaoke": "k.wav", "bleed": "b.wav"}})
    assert len(outs) == 16
    assert outs[slot_names.index("male")] == "m.wav"
    assert outs[slot_names.index("karaoke")] == "k.wav"
    assert outs[slot_names.index("vocals")] is None
    assert gui.slot_outputs({"progress": 10}) == [None] * 16


def test_batch_process_folder(tmp_path):
    (tmp_path / "ok.wav").write_bytes(b"")
    (tmp_path / "zz_bad.wav").write_bytes(b"")
    (tmp_path / "notes.txt").write_bytes(b"")

    def fake_process(path, model, chunk, overlap, fmt):
        if "zz_bad" in path:
            return
        yield {"progress": 100, "status": "Done", "outputs": [path + ".out"]}

    status, outs = gui.batch_process_folder(str(tmp_path), "model", 352800, 2, "wav FLOAT",
                                            process_fn=fake_process)
    assert "1/2" in status and "zz_bad.wav (no progress updates yielded)" in status
    assert outs == [str(tmp_path / "ok.wav") + ".out"]
    status, outs = gui.batch_process_folder("/nonexistent_dir", "m", 1, 2, "wav FLOAT")
    assert "/nonexistent_dir" in status and outs == []


def test_gui_i18n_keys_all_exist_and_no_hardcoded_labels():
    src = _gui_source()
    keys = set(re.findall(r'i18n\("([^"]+)"\)', src))
    table = _table(i18n)
    assert not sorted(k for k in keys if k not in table)
    assert len(keys) >= 90 and len(re.findall(r"i18n\(", src)) >= 120
    assert not re.findall(r'(?:label|info|placeholder)="[A-Za-z][^"]*"', src)
    assert not [k for _, k in gui.STEM_LABELS if k not in table and k not in ("Mid", "Side")]


def test_gui_calls_the_port_only():
    """The UI imports the port's modules and nothing of the JAX package."""
    tree = ast.parse(_gui_source())
    mods = {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    mods |= {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    ours = {m for m in mods if m.startswith("sesa_tpu")}
    assert ours and all(m.startswith("sesa_tpu_torch") for m in ours)
    assert {"sesa_tpu_torch.postprocess.ensemble", "sesa_tpu_torch.postprocess.phase_fixer",
            "sesa_tpu_torch.registry", "sesa_tpu_torch.download",
            "sesa_tpu_torch.apollo_processing"} <= ours


def test_persist_settings(tmp_path, monkeypatch):
    import sesa_tpu_torch.config_manager as cm

    monkeypatch.setattr(cm, "CONFIG_DIR", str(tmp_path))
    monkeypatch.setattr(cm, "CONFIG_FILE", str(tmp_path / "config.json"))
    cfg = cm.load_config()
    gui.persist_settings(cfg["settings"], cfg["favorites"], cfg["presets"], chunk_size=100000,
                         overlap=4, export_format="flac PCM_24", use_tta=True,
                         auto_use_apollo=True, auto_apollo_chunk_size=11,
                         auto_matchering_passes=3)
    reloaded = cm.load_config()["settings"]
    assert (reloaded["chunk_size"], reloaded["overlap"], reloaded["export_format"]) == (
        100000, 4, "flac PCM_24")
    assert reloaded["use_tta"] is True and reloaded["auto_use_apollo"] is True
    assert reloaded["auto_apollo_chunk_size"] == 11 and reloaded["auto_matchering_passes"] == 3
    assert reloaded["apollo_method"] == "normal_method"
    with pytest.raises(KeyError):
        gui.persist_settings(cfg["settings"], cfg["favorites"], cfg["presets"], chunk_sizee=1)


def test_gui_auto_ensemble_wires_apollo_and_matchering():
    fns = {n.name: n for n in ast.walk(ast.parse(_gui_source()))
           if isinstance(n, ast.FunctionDef)}
    args = [a.arg for a in fns["run_auto_ensemble"].args.args]
    for needed in ("use_apollo", "apollo_method", "use_match", "match_passes"):
        assert needed in args
    assert any(isinstance(n, (ast.Yield, ast.YieldFrom))
               for n in ast.walk(fns["run_manual_ensemble"]))


def _options(parser_main):
    """The launcher's parser: its options and their choices, read from the
    parser ``main`` builds (argparse exits on --help before parsing)."""
    import argparse

    seen = {}

    class Stop(Exception):
        pass

    real = argparse.ArgumentParser.parse_args

    def grab(self, *a, **k):
        seen.update({act.dest: (tuple(act.option_strings), act.choices, act.default)
                     for act in self._actions})
        raise Stop

    argparse.ArgumentParser.parse_args = grab
    try:
        with pytest.raises(Stop):
            parser_main([])
    finally:
        argparse.ArgumentParser.parse_args = real
    return seen


def test_launcher_arguments_match_jax():
    assert _options(main.main) == _options(jax_main.main)
    assert _options(main.main)["method"][1] == ["gradio", "localtunnel", "ngrok"]
    assert main.find_free_port(20000) >= 20000


def test_launcher_help_runs():
    r = subprocess.run([sys.executable, "-m", "sesa_tpu_torch.main", "--help"], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "--ngrok-token" in r.stdout and "localtunnel" in r.stdout
