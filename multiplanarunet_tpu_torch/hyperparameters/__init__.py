"""Read-only access to a project's train_hparams.yaml."""
