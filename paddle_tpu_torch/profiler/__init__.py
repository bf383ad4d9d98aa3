from .profiler import (Profiler, ProfilerState, ProfilerTarget, RecordEvent,  # noqa
                       SortedKeys, dump_chrome_trace, export_chrome_tracing,
                       is_recording, load_profiler_result, make_scheduler)
