"""The parameters of each model kind (`perfbench/layouts/<kind>.py`): its
sizes from the configuration, its leaves, the weights the harness makes from
the seed, and each leaf's change from them. Both the kind's system under test
and its plain reference read them; they import nothing of the port."""
