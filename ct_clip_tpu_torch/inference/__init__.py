from .zero_shot import ZeroShotClassifier, pathology_prompts, run_zero_shot

__all__ = ["ZeroShotClassifier", "pathology_prompts", "run_zero_shot"]
