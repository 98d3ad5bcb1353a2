from flute_tpu_torch.utils.benchmark import bench_op, format_gemm_report

__all__ = ["bench_op", "format_gemm_report"]
