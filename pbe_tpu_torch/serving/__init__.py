from pbe_tpu_torch.serving.server import DeadlineExceeded, EditServer, ServerOverloaded

__all__ = ["EditServer", "ServerOverloaded", "DeadlineExceeded"]
