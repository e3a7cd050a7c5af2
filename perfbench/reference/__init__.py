"""Plain float32 references, one a model kind (`perfbench/reference/<kind>.py`).

They import nothing of the port and take nothing it made: the harness hands
them the same weights and tokens it hands the port."""
