"""The program's prior of a configuration, by the config's ``prior.kind``:
``<kind>.py`` here returns the port's prior object (``program(cfg)``)."""
