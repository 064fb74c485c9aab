"""Device-busy ms a step of an MPViT depth net's training over the traced
steps: ``device_ms.train``'s reader (the union of kernel, copy and memset
intervals)."""

from portbench import harness

read = harness.reader("device_ms.train").read
