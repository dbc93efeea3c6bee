"""Serving for the port's LM: the decode step and the continuous batcher
(the port of ``repro/serving``)."""
from repro_torch.serving.batching import (ContinuousBatcher, Request,
                                          SlotScheduler)
from repro_torch.serving.serve_step import (greedy_sample, make_prefill_step,
                                            make_serve_step)

__all__ = ["ContinuousBatcher", "Request", "SlotScheduler", "greedy_sample",
           "make_prefill_step", "make_serve_step"]
