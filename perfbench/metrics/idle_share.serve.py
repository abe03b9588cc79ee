"""idle_share.serve: the share of the traced window in which no operation
ran on the device, read as idle_share.sample reads it, in the serving cell."""

from perfbench import harness

read = harness.reader_of("idle_share.sample").read
