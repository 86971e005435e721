from sesa_tpu_torch.convert.torch_ckpt import convert_checkpoint, load_torch_state_dict  # noqa: F401
