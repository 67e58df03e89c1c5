from r4w_tpu_torch.channel.channel import awgn

__all__ = ["awgn"]
