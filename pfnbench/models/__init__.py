"""The program side of each model kind, by the config's ``model.kind``
(absent: ``pfn``): ``<kind>.py`` here builds the port's model holding the
benchmark's weights and counts its work (``spec.program_model``); its
reference side is ``reference/model_<kind>.py``."""
