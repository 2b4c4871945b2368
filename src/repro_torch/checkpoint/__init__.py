from repro_torch.checkpoint.io import save_checkpoint, load_checkpoint, latest_step
