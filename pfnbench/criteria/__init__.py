"""The program's criterion of a configuration, by ``criterion.kind``:
``<kind>.py`` here returns the port's criterion (``program(borders)``)."""
