"""Mean host time of one ``InferenceEngine.infer_group`` call in the
traced window, from the benchmark's span around it (the call ends in a
copy to the host, so it waits for the device). Layer: engine."""

from portbench.lib.readers import dispatch_ms as read  # noqa: F401
