"""The four Figure-1 workflows and their profiled parameters (§2.1, §6),
copied from the JAX package so that the port stands alone.

Model sizes follow the paper's description: each model object is "several
GB in size" and the aggregate over the full set of DFGs is "nearly 35 GB"
(§2.2), exceeding a single 16 GB T4.  Runtimes are chosen so that on an
idle system with models cached the completion times fall in the paper's
reported 1–3 s range (§6), and so that the image-description and
3D-perception pipelines have "relatively short runtimes" compared to the
translation and Q&A pipelines (§6.2.2).

Model id space 0..63 per the SST bitmap encoding.  The mt5 model plays two
roles in the translation pipeline but is a single model object; BART is
shared between the image-caption and VPA pipelines — exactly the
cross-pipeline model reuse the paper exploits (§3.3).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from repro_torch.core.types import DFG, GB, MB, MLModel, TaskSpec, models_from_specs

# -- model catalog ------------------------------------------------------------
# id: (name, decompressed GPU bytes)
MODEL_SPECS: Dict[int, Tuple[str, float]] = {
    0: ("opt-1.3b", 6.5 * GB),
    1: ("marian-en-fr", 2.2 * GB),
    2: ("mt5-zh-ja-en", 5.8 * GB),
    3: ("vit-gpt2-captioning", 4.2 * GB),
    4: ("espnet-tts", 3.1 * GB),
    5: ("bart-large", 4.8 * GB),
    6: ("detr-resnet", 3.4 * GB),
    7: ("glpn-depth", 3.6 * GB),
}
# Aggregate = 33.6 GB ≈ "nearly 35GB" (§2.2).

MODELS: Dict[int, MLModel] = models_from_specs(MODEL_SPECS)


def translation_dfg() -> DFG:
    """Fig. 1a: multilingual meeting auto-caption.  OPT preprocess → Marian
    (fr) ∥ mt5 (zh) ∥ mt5 (ja) → aggregate."""
    return DFG(
        "translation",
        tasks=[
            TaskSpec("opt_ingest", 0.80, model_id=0, output_bytes=0.3 * MB,
                     input_bytes=0.2 * MB),
            TaskSpec("marian_fr", 0.33, model_id=1, output_bytes=0.1 * MB),
            TaskSpec("mt5_zh", 0.40, model_id=2, output_bytes=0.1 * MB),
            TaskSpec("mt5_ja", 0.40, model_id=2, output_bytes=0.1 * MB),
            TaskSpec("aggregate", 0.04, model_id=None, output_bytes=0.3 * MB),
        ],
        edges=[
            ("opt_ingest", "marian_fr"),
            ("opt_ingest", "mt5_zh"),
            ("opt_ingest", "mt5_ja"),
            ("marian_fr", "aggregate"),
            ("mt5_zh", "aggregate"),
            ("mt5_ja", "aggregate"),
        ],
    )


def image_caption_dfg() -> DFG:
    """Fig. 1b: children's-education image reader.  ViT-GPT2 caption →
    BART child-safety filter → ESPnet vocalization."""
    return DFG(
        "image_caption",
        tasks=[
            TaskSpec("vit_gpt2_caption", 0.15, model_id=3,
                     output_bytes=0.05 * MB, input_bytes=2.0 * MB),
            TaskSpec("bart_safety", 0.07, model_id=5, output_bytes=0.05 * MB),
            TaskSpec("espnet_tts", 0.12, model_id=4, output_bytes=1.5 * MB),
        ],
        edges=[
            ("vit_gpt2_caption", "bart_safety"),
            ("bart_safety", "espnet_tts"),
        ],
    )


def vpa_dfg() -> DFG:
    """Fig. 1c: virtual personal assistant Q&A.  OPT (prompted) → BART
    (adult-targeted)."""
    return DFG(
        "vpa_dialogue",
        tasks=[
            TaskSpec("opt_dialogue", 0.95, model_id=0, output_bytes=0.2 * MB,
                     input_bytes=0.1 * MB),
            TaskSpec("bart_shape", 0.52, model_id=5, output_bytes=0.2 * MB),
        ],
        edges=[("opt_dialogue", "bart_shape")],
    )


def perception_dfg() -> DFG:
    """Fig. 1d: vision-impaired assistance.  DETR object detection ∥ GLPN
    depth estimation → combine."""
    return DFG(
        "perception3d",
        tasks=[
            TaskSpec("detr_objects", 0.14, model_id=6, output_bytes=0.4 * MB,
                     input_bytes=2.0 * MB),
            TaskSpec("glpn_depth", 0.16, model_id=7, output_bytes=1.0 * MB,
                     input_bytes=2.0 * MB),
            TaskSpec("combine", 0.03, model_id=None, output_bytes=0.5 * MB),
        ],
        edges=[
            ("detr_objects", "combine"),
            ("glpn_depth", "combine"),
        ],
    )


def paper_dfgs() -> List[DFG]:
    return [translation_dfg(), image_caption_dfg(), vpa_dfg(), perception_dfg()]


# Mixture weights for "a mix of the four workflows" (§6): uniform.
DFG_MIX: List[Tuple[str, float]] = [
    ("translation", 0.25),
    ("image_caption", 0.25),
    ("vpa_dialogue", 0.25),
    ("perception3d", 0.25),
]
