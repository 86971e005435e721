"""Gradio web UI: the 7-tab interface (counterpart of sesa_tpu/gui.py).

Functional parity with reference gui.py:87-1548 — tabs for Audio
Separation, Auto Ensemble, Download Sources, Manual Ensemble, Phase Fixer,
Batch Processing, and Custom Models, with favorites (⭐), presets, model
category dropdowns, Apollo/Matchering options, and HTML progress bars.
(The reference's Batch Processing tab is a stub that never processes —
gui.py:1139-1180; this one actually iterates the folder.)

Every label/info/status string routes through ``I18nAuto`` using the keys
the 11 shipped locale tables define (the reference's key map:
gui.py:87-1548 passim) — switching language changes the whole UI.
Widget CHOICE values that downstream code matches on (ensemble methods,
apollo method names, export formats) are passed as (translated_label,
raw_value) pairs so translation can never corrupt the data path.

User settings persist: clicking Process / Process Ensemble writes the
current widget values back through config_manager (reference behavior,
config_manager.py:9-76 + gui.py settings plumbing), so choices survive a
restart.

The processing behind every tab is the port's (``processing``,
``postprocess.ensemble``, ``postprocess.phase_fixer``), on the card by
default. gradio is an optional dependency: importing this module works
without it, ``create_interface`` raises a clear error.
"""

from __future__ import annotations

import html
import os
from typing import List

from sesa_tpu_torch import config_manager as cm
from sesa_tpu_torch import helpers, processing
from sesa_tpu_torch.i18n import I18nAuto
from sesa_tpu_torch.postprocess.ensemble import ENSEMBLE_METHODS
from sesa_tpu_torch.postprocess.phase_fixer import SOURCE_MODELS, TARGET_MODELS, process_phase_fix

try:
    import gradio as gr

    GRADIO_AVAILABLE = True
except ImportError:
    gr = None
    GRADIO_AVAILABLE = False

i18n = I18nAuto()

CSS = """
#header { text-align: center; }
.progress-bar { height: 18px; border-radius: 9px; background: #2d2d44; }
.progress-fill { height: 100%; border-radius: 9px;
  background: linear-gradient(90deg, #6366f1, #a855f7); }
"""


def progress_html(pct: int, label: str = "") -> str:
    pct = max(0, min(100, int(pct)))
    # status text can carry exception reprs ('<class ...>'): escape it so
    # metacharacters can't corrupt the rendered HTML
    return (
        f'<div class="progress-bar"><div class="progress-fill" '
        f'style="width:{pct}%"></div></div><p>{html.escape(label)} {pct}%</p>'
    )


# All 16 output stem slots, in display order (reference gui.py:523-552
# renders one gr.Audio per slot; processing.py fills the same 16 keys).
# The second element is the i18n key for the slot's display label
# (reference labels them via i18n: gui.py:523-552; 'Mid'/'Side' have no
# table key and fall back to the literal).
STEM_LABELS = [
    ("vocals", "vocals"), ("instrumental", "instrumental"),
    ("phaseremix", "phase_remix"), ("drum", "drums"),
    ("bass", "bass"), ("other", "other"),
    ("effects", "effects"), ("speech", "speech"),
    ("music", "music"), ("dry", "dry"),
    ("male", "male"), ("female", "female"),
    ("bleed", "bleed"), ("karaoke", "karaoke"),
    ("mid", "Mid"), ("side", "Side"),
]

# export-format choices: raw values the pipeline matches on; labels are the
# values themselves (format strings like 'wav FLOAT' are not translated)
EXPORT_FORMATS = ["wav FLOAT", "flac PCM_16", "flac PCM_24"]


def apollo_method_choices():
    """(translated label, raw value) pairs — processing matches on the raw
    'normal_method'/'mid_side_method' strings (apollo_processing.py)."""
    return [(i18n("normal_method"), "normal_method"),
            (i18n("mid_side_method"), "mid_side_method")]


def persist_settings(settings: dict, favorites: list, presets: dict,
                     **updates) -> dict:
    """Write widget values back into the persisted user settings
    (reference round-trips settings through config_manager.py:9-76 on
    every process click). Unknown keys are rejected loudly — a typo'd
    widget key must fail a test, not silently persist garbage."""
    unknown = set(updates) - set(cm.DEFAULT_CONFIG["settings"])
    if unknown:
        raise KeyError(f"not a persisted setting: {sorted(unknown)}")
    settings.update(updates)
    cm.save_config(favorites, settings, presets)
    return settings


def slot_outputs(upd: dict) -> List:
    """Map a processing.process_audio update onto the 16 stem outputs, in
    STEM_LABELS order (keys match processing.STEM_SLOTS)."""
    slots = upd.get("slots", {}) or {}
    return [slots.get(name) for name, _ in STEM_LABELS]


def batch_process_folder(folder, model, chunk_size, overlap, export_format,
                         process_fn=None):
    """Process every audio file in a folder; returns (status, output paths).

    One corrupt file must not abort the batch or discard the outputs of
    files already processed — and a file whose processing yields NO updates
    is reported as failed, not crashed (the reference's Batch tab never
    processes at all, gui.py:1139-1180)."""
    if not folder or not os.path.isdir(folder):
        return i18n("directory_not_exist_warning").format(folder), []
    process_fn = process_fn or processing.process_audio
    outs = []
    failed = []
    files = sorted(
        f for f in os.listdir(folder)
        if f.lower().endswith((".wav", ".flac", ".mp3", ".ogg"))
    )
    for name in files:
        upd = None
        try:
            for upd in process_fn(
                os.path.join(folder, name), model, int(chunk_size),
                int(overlap), export_format,
            ):
                pass
            if upd is None:
                raise RuntimeError("no progress updates yielded")
            outs.extend(upd.get("outputs", []))
        except Exception as e:
            failed.append(f"{name} ({e})")
    ok = len(files) - len(failed)
    status = i18n("batch_completed") + f" {ok}/{len(files)}"
    if failed:
        status += "; " + i18n("error_log").format(", ".join(failed[:5]))
    return status, outs


def _model_choices(category: str, favorites: List[str]) -> List[str]:
    from sesa_tpu_torch.registry import get_all_model_configs_with_custom

    configs = get_all_model_configs_with_custom()
    names = list(configs.get(category, {}))
    return [f"{n} ⭐" if n in favorites else n for n in names]


def _categories() -> List[str]:
    from sesa_tpu_torch.registry import get_all_model_configs_with_custom

    return list(get_all_model_configs_with_custom())


def create_interface():
    """Build the Blocks app (reference gui.py:87)."""
    if not GRADIO_AVAILABLE:
        raise RuntimeError(
            "The web UI requires the optional 'gradio' package; install it or "
            "use the CLI (python -m sesa_tpu_torch.cli)."
        )

    config = cm.load_config()
    favorites = config["favorites"]
    settings = config["settings"]

    def run_process(audio_path, model, chunk_size, overlap, export_format,
                    use_tta, phaseremix, extract_inst, use_apollo,
                    apollo_chunk, apollo_over, apollo_method, apollo_normal,
                    apollo_mid, use_match, match_passes):
        # persist the choices before processing so they survive a restart
        # even if the run is interrupted (reference saves on every click)
        persist_settings(
            settings, favorites, config["presets"],
            chunk_size=int(chunk_size), overlap=int(overlap),
            export_format=export_format, use_tta=bool(use_tta),
            use_demud_phaseremix_inst=bool(phaseremix),
            extract_instrumental=bool(extract_inst),
            use_apollo=bool(use_apollo),
            apollo_chunk_size=int(apollo_chunk),
            apollo_overlap=int(apollo_over), apollo_method=apollo_method,
            apollo_normal_model=apollo_normal,
            apollo_midside_model=apollo_mid,
            use_matchering=bool(use_match),
            matchering_passes=int(match_passes),
            selected_model=cm.clean_model(model) if model else None,
        )
        outputs_final = [None] * len(STEM_LABELS)
        html = progress_html(0, i18n("starting_audio_separation"))
        for upd in processing.process_audio(
            audio_path, model, int(chunk_size), int(overlap), export_format,
            use_tta=use_tta, demud_phaseremix_inst=phaseremix,
            extract_instrumental=extract_inst, use_apollo=use_apollo,
            apollo_chunk_size=apollo_chunk, apollo_overlap=apollo_over,
            apollo_method=apollo_method, apollo_normal_model=apollo_normal,
            apollo_midside_model=apollo_mid, use_matchering=use_match,
            matchering_passes=int(match_passes),
        ):
            html = progress_html(upd["progress"], upd["status"])
            outputs_final = slot_outputs(upd)
            yield [html] + outputs_final

    def run_auto_ensemble(audio_path, models, chunk_size, overlap, etype,
                          export_format, use_tta, extract_inst,
                          use_apollo, apollo_chunk, apollo_over,
                          apollo_method, apollo_normal, apollo_mid,
                          use_match, match_passes):
        persist_settings(
            settings, favorites, config["presets"],
            auto_use_tta=bool(use_tta),
            auto_extract_instrumental=bool(extract_inst),
            auto_ensemble_type=etype,
            auto_use_apollo=bool(use_apollo),
            auto_apollo_chunk_size=int(apollo_chunk),
            auto_apollo_overlap=int(apollo_over),
            auto_apollo_method=apollo_method,
            auto_apollo_normal_model=apollo_normal,
            auto_apollo_midside_model=apollo_mid,
            auto_use_matchering=bool(use_match),
            auto_matchering_passes=int(match_passes),
            selected_models=[m.replace(" ⭐", "") for m in (models or [])],
        )
        html = progress_html(0, i18n("starting_ensemble_process"))
        out = None
        for upd in processing.auto_ensemble_process(
            audio_path, [m for m in (models or [])], int(chunk_size),
            int(overlap), export_format, use_tta=use_tta,
            extract_instrumental=extract_inst, ensemble_type=etype,
            use_apollo=use_apollo, apollo_chunk_size=int(apollo_chunk),
            apollo_overlap=int(apollo_over), apollo_method=apollo_method,
            apollo_normal_model=apollo_normal,
            apollo_midside_model=apollo_mid, use_matchering=use_match,
            matchering_passes=int(match_passes),
        ):
            html = progress_html(upd["progress"], upd["status"])
            out = upd["outputs"][0] if upd.get("outputs") else None
            yield html, out

    def run_manual_ensemble(files, method, weights):
        # a GENERATOR like its two siblings, so the progress bar moves
        # during a long ensemble (reference streams manual-ensemble
        # progress too, processing.py:706-795)
        out = None
        html = progress_html(0, i18n("starting_ensemble_process"))
        yield html, out
        paths = [f.name if hasattr(f, "name") else f for f in (files or [])]
        for upd in processing.ensemble_audio_fn(paths, method, weights):
            html = progress_html(upd["progress"], upd["status"])
            out = upd["outputs"][0] if upd.get("outputs") else None
            yield html, out

    def run_download(url):
        from sesa_tpu_torch.download import download_callback

        path, status = download_callback(url)
        return status, path

    def run_phase_fix(source_file, target_file, low, high, scale):
        if not source_file or not target_file:
            return i18n("please_upload_both_files"), None
        src = source_file.name if hasattr(source_file, "name") else source_file
        tgt = target_file.name if hasattr(target_file, "name") else target_file
        out, msg = process_phase_fix(src, tgt, helpers.OUTPUT_DIR,
                                     low_cutoff=low, high_cutoff=high,
                                     scale_factor=scale)
        return msg, out

    def run_batch(folder, model, chunk_size, overlap, export_format):
        return batch_process_folder(folder, model, chunk_size, overlap,
                                    export_format)

    def add_custom(name, mtype, ckpt_url, cfg_url):
        from sesa_tpu_torch.registry import add_custom_model

        ok, msg = add_custom_model(name, mtype or "auto", ckpt_url, cfg_url)
        return msg

    def toggle_favorite(model, add):
        nonlocal favorites
        favorites = cm.update_favorites(favorites, cm.clean_model(model), add=add)
        cm.save_config(favorites, settings, config["presets"])
        return f"⭐ {favorites}"

    with gr.Blocks(css=CSS, title="SESA TPU Audio Separation") as app:
        gr.Markdown(f"# SESA TPU — {i18n('ultimate_audio_separation')}",
                    elem_id="header")

        with gr.Tab(i18n("audio_separation_tab")):
            with gr.Row():
                with gr.Column():
                    input_audio = gr.Audio(type="filepath",
                                           label=i18n("upload_file"))
                    category = gr.Dropdown(
                        choices=_categories(),
                        value=settings.get("model_category", "Vocal Models"),
                        label=i18n("category"))
                    model = gr.Dropdown(
                        choices=_model_choices(
                            settings.get("model_category", "Vocal Models"),
                            favorites),
                        value=settings.get("selected_model") or None,
                        label=i18n("model"))
                    category.change(
                        lambda c: gr.update(choices=_model_choices(c, favorites)),
                        category, model)
                    with gr.Row():
                        fav_add = gr.Button("⭐ " + i18n("add_favorite"))
                        fav_rm = gr.Button(i18n("remove_favorite"))
                    fav_status = gr.Markdown()
                    fav_add.click(lambda m: toggle_favorite(m, True), model, fav_status)
                    fav_rm.click(lambda m: toggle_favorite(m, False), model, fav_status)

                    chunk_size = gr.Number(value=settings["chunk_size"],
                                           label=i18n("chunk_size"),
                                           info=i18n("chunk_size_info"))
                    overlap = gr.Slider(2, 50, value=settings["overlap"],
                                        step=1, label=i18n("overlap"),
                                        info=i18n("overlap_info"))
                    export_format = gr.Dropdown(
                        EXPORT_FORMATS,
                        value=settings["export_format"],
                        label=i18n("output_format"),
                        info=i18n("export_format_help"))
                    use_tta = gr.Checkbox(value=settings["use_tta"],
                                          label=i18n("tta_boost"),
                                          info=i18n("tta_info"))
                    phaseremix = gr.Checkbox(
                        value=settings["use_demud_phaseremix_inst"],
                        label=i18n("phase_fix"), info=i18n("phase_fix_info"))
                    extract_inst = gr.Checkbox(
                        value=settings["extract_instrumental"],
                        label=i18n("instrumental"),
                        info=i18n("instrumental_info"))
                    with gr.Accordion(i18n("enhance_with_apollo"), open=False):
                        use_apollo = gr.Checkbox(
                            value=settings["use_apollo"],
                            label=i18n("enhance_with_apollo"),
                            info=i18n("apollo_enhancement_info"))
                        apollo_chunk = gr.Slider(
                            3, 25, value=settings["apollo_chunk_size"], step=1,
                            label=i18n("apollo_chunk_size"),
                            info=i18n("apollo_chunk_size_info"))
                        apollo_over = gr.Slider(
                            2, 10, value=settings["apollo_overlap"], step=1,
                            label=i18n("apollo_overlap"),
                            info=i18n("apollo_overlap_info"))
                        apollo_method = gr.Radio(
                            apollo_method_choices(),
                            value=settings["apollo_method"],
                            label=i18n("apollo_processing_method"))
                        from sesa_tpu_torch.apollo_processing import APOLLO_MODELS

                        apollo_normal = gr.Dropdown(
                            list(APOLLO_MODELS),
                            value=settings["apollo_normal_model"],
                            label=i18n("apollo_normal_model"))
                        apollo_mid = gr.Dropdown(
                            list(APOLLO_MODELS),
                            value=settings["apollo_midside_model"],
                            label=i18n("apollo_mid_side_model"))
                    with gr.Accordion(i18n("apply_matchering"), open=False):
                        use_match = gr.Checkbox(
                            value=settings["use_matchering"],
                            label=i18n("apply_matchering"),
                            info=i18n("matchering_info"))
                        match_passes = gr.Slider(
                            1, 5, value=settings["matchering_passes"], step=1,
                            label=i18n("matchering_passes"),
                            info=i18n("matchering_passes_info"))
                    process_btn = gr.Button(i18n("process"), variant="primary")
                with gr.Column():
                    progress = gr.HTML(progress_html(0))
                    # all 16 stem slots (reference gui.py:523-552), two per
                    # row; models only fill the slots they produce, the rest
                    # stay empty
                    stem_audios = []
                    for i in range(0, len(STEM_LABELS), 2):
                        with gr.Row():
                            for _, key in STEM_LABELS[i:i + 2]:
                                stem_audios.append(gr.Audio(label=i18n(key)))
            process_btn.click(
                run_process,
                [input_audio, model, chunk_size, overlap, export_format, use_tta,
                 phaseremix, extract_inst, use_apollo, apollo_chunk, apollo_over,
                 apollo_method, apollo_normal, apollo_mid, use_match, match_passes],
                [progress] + stem_audios,
            )

        with gr.Tab(i18n("auto_ensemble_tab")):
            with gr.Row():
                with gr.Column():
                    ae_audio = gr.Audio(type="filepath",
                                        label=i18n("upload_file"))
                    ae_category = gr.Dropdown(
                        choices=_categories(),
                        value=settings.get("auto_category_dropdown",
                                           "Vocal Models"),
                        label=i18n("model_category"))
                    ae_models = gr.CheckboxGroup(
                        choices=_model_choices(
                            settings.get("auto_category_dropdown",
                                         "Vocal Models"), favorites),
                        label=i18n("select_models"))
                    ae_category.change(
                        lambda c: gr.update(choices=_model_choices(c, favorites)),
                        ae_category, ae_models)
                    ae_type = gr.Dropdown(
                        list(ENSEMBLE_METHODS),
                        value=settings.get("auto_ensemble_type", "avg_wave"),
                        label=i18n("ensemble_algorithm"),
                        info=i18n("ensemble_type_help"))
                    ae_chunk = gr.Number(value=settings["chunk_size"],
                                         label=i18n("auto_chunk_size"),
                                         info=i18n("chunk_size_info"))
                    ae_overlap = gr.Slider(2, 50, value=settings["overlap"],
                                           step=1, label=i18n("auto_overlap"),
                                           info=i18n("overlap_info"))
                    ae_format = gr.Dropdown(EXPORT_FORMATS, value="wav FLOAT",
                                            label=i18n("output_format"))
                    ae_tta = gr.Checkbox(value=settings["auto_use_tta"],
                                         label=i18n("tta_boost"),
                                         info=i18n("tta_info"))
                    ae_inst = gr.Checkbox(
                        value=settings["auto_extract_instrumental"],
                        label=i18n("instrumental_only"))
                    # Apollo + Matchering on the Auto Ensemble tab: the
                    # orchestrator accepts all of these kwargs
                    # (processing.py auto_ensemble_process); reference
                    # gui.py:611 (auto_use_apollo), :671-677 (matchering
                    # group), :1523-1529 (wired into the click)
                    with gr.Accordion(i18n("enhance_with_apollo"), open=False):
                        ae_apollo = gr.Checkbox(
                            value=settings["auto_use_apollo"],
                            label=i18n("enhance_with_apollo"),
                            info=i18n("apollo_enhancement_info"))
                        ae_apollo_chunk = gr.Slider(
                            3, 25, value=settings["auto_apollo_chunk_size"],
                            step=1, label=i18n("auto_apollo_chunk_size"),
                            info=i18n("auto_apollo_chunk_size_info"))
                        ae_apollo_over = gr.Slider(
                            2, 10, value=settings["auto_apollo_overlap"],
                            step=1, label=i18n("auto_apollo_overlap"),
                            info=i18n("auto_apollo_overlap_info"))
                        ae_apollo_method = gr.Radio(
                            apollo_method_choices(),
                            value=settings["auto_apollo_method"],
                            label=i18n("apollo_processing_method"))
                        from sesa_tpu_torch.apollo_processing import APOLLO_MODELS

                        ae_apollo_normal = gr.Dropdown(
                            list(APOLLO_MODELS),
                            value=settings["auto_apollo_normal_model"],
                            label=i18n("apollo_normal_model"))
                        ae_apollo_mid = gr.Dropdown(
                            list(APOLLO_MODELS),
                            value=settings["auto_apollo_midside_model"],
                            label=i18n("apollo_mid_side_model"))
                    with gr.Accordion(i18n("apply_matchering"), open=False):
                        ae_match = gr.Checkbox(
                            value=settings["auto_use_matchering"],
                            label=i18n("apply_matchering"),
                            info=i18n("matchering_info"))
                        ae_match_passes = gr.Slider(
                            1, 5, value=settings["auto_matchering_passes"],
                            step=1, label=i18n("matchering_passes"),
                            info=i18n("matchering_passes_info"))
                    ae_btn = gr.Button(i18n("process_ensemble"),
                                       variant="primary")
                    # presets: persisted model-selection bundles
                    # (reference gui.py presets / config_manager.py:96-128)
                    with gr.Accordion(i18n("ensemble_settings"), open=False):
                        preset_dd = gr.Dropdown(
                            choices=sorted(config["presets"]),
                            label=i18n("select_preset"))
                        preset_name = gr.Textbox(
                            label=i18n("preset_name"),
                            placeholder=i18n("enter_preset_name"))
                        with gr.Row():
                            preset_load = gr.Button(i18n("refresh_presets"))
                            preset_save = gr.Button(i18n("save_preset"))
                            preset_del = gr.Button(i18n("delete_preset"))
                        preset_status = gr.Markdown()
                with gr.Column():
                    ae_progress = gr.HTML(progress_html(0))
                    ae_out = gr.Audio(label=i18n("ensembled_output"))
            ae_btn.click(run_auto_ensemble,
                         [ae_audio, ae_models, ae_chunk, ae_overlap, ae_type,
                          ae_format, ae_tta, ae_inst,
                          ae_apollo, ae_apollo_chunk, ae_apollo_over,
                          ae_apollo_method, ae_apollo_normal, ae_apollo_mid,
                          ae_match, ae_match_passes],
                         [ae_progress, ae_out])

            def _decorate(models):
                return [f"{m} ⭐" if m in favorites else m for m in models]

            def preset_save_fn(name, category, models, etype, chunk, overlap):
                if not name:
                    return gr.update(), i18n("no_preset_name_provided")
                # record the category too (reference gui.py:729-766 saves
                # auto_category_dropdown): without it the loaded model
                # names may be absent from the CheckboxGroup's choices
                config["presets"] = cm.save_preset(
                    config["presets"], name,
                    [m.replace(" ⭐", "") for m in (models or [])], etype,
                    chunk_size=chunk, overlap=overlap,
                    auto_category_dropdown=category)
                cm.save_config(favorites, settings, config["presets"])
                return (gr.update(choices=sorted(config["presets"]), value=name),
                        i18n("preset_saved").format(name))

            def preset_delete_fn(name):
                if not name:
                    return gr.update(), i18n("select_preset")
                config["presets"] = cm.delete_preset(config["presets"], name)
                cm.save_config(favorites, settings, config["presets"])
                return (gr.update(choices=sorted(config["presets"]), value=None),
                        i18n("success_log").format(name))

            def preset_load_fn(name):
                p = config["presets"].get(name)
                if not p:
                    return (gr.update(), gr.update(), gr.update(), gr.update(),
                            gr.update(), i18n("select_preset"))
                cat = p.get("auto_category_dropdown") or "Vocal Models"
                return (gr.update(value=cat),
                        gr.update(choices=_model_choices(cat, favorites),
                                  value=_decorate(p.get("models", []))),
                        gr.update(value=p.get("ensemble_method", "avg_wave")),
                        gr.update(value=p.get("chunk_size") or settings["chunk_size"]),
                        gr.update(value=p.get("overlap") or settings["overlap"]),
                        i18n("success_log").format(name))

            preset_save.click(preset_save_fn,
                              [preset_name, ae_category, ae_models, ae_type,
                               ae_chunk, ae_overlap],
                              [preset_dd, preset_status])
            preset_del.click(preset_delete_fn, [preset_dd],
                             [preset_dd, preset_status])
            preset_load.click(preset_load_fn, [preset_dd],
                              [ae_category, ae_models, ae_type, ae_chunk,
                               ae_overlap, preset_status])

        with gr.Tab(i18n("download_sources_tab")):
            url_in = gr.Textbox(label=i18n("audio_file_url"))
            dl_btn = gr.Button(i18n("download_from_url"))
            dl_status = gr.Markdown()
            dl_audio = gr.Audio(label=i18n("downloaded_file"))
            dl_btn.click(run_download, url_in, [dl_status, dl_audio])

        with gr.Tab(i18n("manual_ensemble_tab")):
            me_files = gr.File(file_count="multiple",
                               label=i18n("select_audio_files"))
            me_method = gr.Dropdown(
                list(ENSEMBLE_METHODS),
                value=settings.get("manual_ensemble_type", "avg_wave"),
                label=i18n("ensemble_algorithm"),
                info=i18n("ensemble_type_help"))
            me_weights = gr.Textbox(label=i18n("custom_weights"),
                                    info=i18n("custom_weights_info"),
                                    placeholder=i18n("custom_weights_placeholder"))
            me_btn = gr.Button(i18n("process_ensemble"))
            me_progress = gr.HTML(progress_html(0))
            me_out = gr.Audio(label=i18n("ensembled_output"))
            me_btn.click(run_manual_ensemble, [me_files, me_method, me_weights],
                         [me_progress, me_out])

        with gr.Tab(i18n("phase_fixer_tab")):
            gr.Markdown(i18n("phase_fix_info") +
                        f" — {len(SOURCE_MODELS)}/{len(TARGET_MODELS)} "
                        + i18n("source_model") + "/" + i18n("target_model"))
            pf_source = gr.File(label=i18n("source_file_label"))
            pf_target = gr.File(label=i18n("target_file_label"))
            pf_low = gr.Slider(100, 2000, value=500,
                               label=i18n("low_cutoff"),
                               info=i18n("low_cutoff_info"))
            pf_high = gr.Slider(3000, 16000, value=9000,
                                label=i18n("high_cutoff"),
                                info=i18n("high_cutoff_info"))
            pf_scale = gr.Slider(0.5, 3.0, value=1.4,
                                 label=i18n("scale_factor"),
                                 info=i18n("scale_factor_info"))
            pf_btn = gr.Button(i18n("run_phase_fixer"))
            pf_status = gr.Markdown()
            pf_out = gr.Audio(label=i18n("phase_fixed_output"))
            pf_btn.click(run_phase_fix, [pf_source, pf_target, pf_low, pf_high, pf_scale],
                         [pf_status, pf_out])

        with gr.Tab(i18n("batch_processing_tab")):
            gr.Markdown(i18n("batch_description"))
            bp_folder = gr.Textbox(
                label=i18n("batch_input_folder"),
                placeholder=i18n("batch_input_folder_placeholder"))
            bp_category = gr.Dropdown(choices=_categories(),
                                      value="Vocal Models",
                                      label=i18n("model_category"))
            bp_model = gr.Dropdown(choices=_model_choices("Vocal Models", favorites),
                                   label=i18n("model"))
            bp_category.change(lambda c: gr.update(choices=_model_choices(c, favorites)),
                               bp_category, bp_model)
            bp_chunk = gr.Number(value=settings["chunk_size"],
                                 label=i18n("chunk_size"),
                                 info=i18n("chunk_size_info"))
            bp_overlap = gr.Slider(2, 50, value=2, step=1,
                                   label=i18n("overlap"),
                                   info=i18n("overlap_info"))
            bp_format = gr.Dropdown(EXPORT_FORMATS, value="wav FLOAT",
                                    label=i18n("output_format"))
            bp_btn = gr.Button(i18n("batch_start"), variant="primary")
            bp_status = gr.Markdown()
            bp_files = gr.File(file_count="multiple",
                               label=i18n("batch_file_list"))
            bp_btn.click(run_batch, [bp_folder, bp_model, bp_chunk, bp_overlap, bp_format],
                         [bp_status, bp_files])

        with gr.Tab(i18n("custom_models_tab")):
            gr.Markdown(i18n("custom_model_info"))
            cm_name = gr.Textbox(label=i18n("custom_model_name"),
                                 placeholder=i18n("custom_model_name_placeholder"))
            cm_type = gr.Dropdown(["auto", "bs_roformer", "mel_band_roformer", "mdx23c",
                                   "scnet", "bandit_v2", "htdemucs"], value="auto",
                                  label=i18n("model_type"),
                                  info=i18n("auto_detect_type"))
            cm_ckpt = gr.Textbox(label=i18n("checkpoint_url"),
                                 placeholder=i18n("checkpoint_url_placeholder"))
            cm_cfg = gr.Textbox(label=i18n("config_url"),
                                placeholder=i18n("config_url_placeholder"))
            cm_btn = gr.Button(i18n("add_model_btn"))
            cm_status = gr.Markdown()

            def add_custom_and_refresh(name, mtype, ckpt_url, cfg_url):
                # refresh the category dropdowns so the just-added model is
                # selectable without a restart (reference gui.py:1352)
                msg = add_custom(name, mtype, ckpt_url, cfg_url)
                cats = gr.update(choices=_categories())
                return msg, cats, cats, cats

            cm_btn.click(add_custom_and_refresh,
                         [cm_name, cm_type, cm_ckpt, cm_cfg],
                         [cm_status, category, ae_category, bp_category])

    return app
