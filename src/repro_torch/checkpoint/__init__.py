from repro_torch.checkpoint.io import restore_checkpoint, save_checkpoint
