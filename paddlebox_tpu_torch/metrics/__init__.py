"""Training metrics accumulated on the device."""

from paddlebox_tpu_torch.metrics.variants import MetricGroup, MetricSpec  # noqa: F401
