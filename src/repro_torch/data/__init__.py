from repro_torch.data.pipeline import DataPipeline, make_batch_iterator  # noqa: F401
