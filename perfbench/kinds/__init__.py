"""The system under test for each model kind, found by the configuration's
`kind` (`perfbench/kinds/<kind>.py`)."""
