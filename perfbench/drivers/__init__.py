"""One driver a configuration kind, named by the configuration's
``driver``: ``Driver(config, traffic, seed, device)`` builds the program
for the configuration and runs its chunks (``setup``, ``chunk``), then
frees the program (``release``) and checks what it produced (``check``)."""
