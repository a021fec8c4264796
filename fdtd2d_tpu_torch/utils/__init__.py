from fdtd2d_tpu_torch.utils.metrics import Timer, throughput_gcells, device_info

__all__ = ["Timer", "throughput_gcells", "device_info"]
