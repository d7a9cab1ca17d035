from .pipeline import (DataConfig, SyntheticLMDataset, pack_documents,  # noqa: F401
                       sharded_batches)
