"""Host data pipelines: the augment chain, sample getters and loaders."""
