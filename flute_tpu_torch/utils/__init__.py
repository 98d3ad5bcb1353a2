from flute_tpu_torch.utils.benchmark import bench_cycled, bench_op, format_gemm_report

__all__ = ["bench_cycled", "bench_op", "format_gemm_report"]
