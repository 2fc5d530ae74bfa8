"""The paper's four workflows and the zoo's serving pipelines, copied
from the JAX package so that the port stands alone."""

from repro_torch.workflows.paper_pipelines import (
    DFG_MIX,
    MODELS,
    MODEL_SPECS,
    image_caption_dfg,
    paper_dfgs,
    perception_dfg,
    translation_dfg,
    vpa_dfg,
)

__all__ = [
    "DFG_MIX",
    "MODELS",
    "MODEL_SPECS",
    "image_caption_dfg",
    "paper_dfgs",
    "perception_dfg",
    "translation_dfg",
    "vpa_dfg",
]
