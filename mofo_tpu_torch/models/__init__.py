from mofo_tpu_torch.models.registry import create_model, list_models

__all__ = ["create_model", "list_models"]
