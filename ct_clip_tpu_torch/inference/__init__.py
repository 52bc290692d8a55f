from .latents import export_latents
from .zero_shot import ZeroShotClassifier, pathology_prompts, run_zero_shot

__all__ = ["ZeroShotClassifier", "export_latents", "pathology_prompts",
           "run_zero_shot"]
