from .metrics import auroc, evaluate_internal, write_table

__all__ = ["auroc", "evaluate_internal", "write_table"]
