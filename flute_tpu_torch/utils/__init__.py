from flute_tpu_torch.utils.benchmark import bench_op

__all__ = ["bench_op"]
