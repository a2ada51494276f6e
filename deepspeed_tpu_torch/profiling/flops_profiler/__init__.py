from deepspeed_tpu_torch.profiling.flops_profiler.profiler import (
    FlopsProfiler, analyze_fn, duration_to_string, flops_to_string,
    get_model_profile, macs_to_string, number_to_string, params_to_string)
