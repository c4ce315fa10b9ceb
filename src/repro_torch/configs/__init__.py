"""Architecture configs: data copies of the reference package's ``configs/``
(``ArchConfig``, ``ARCH_IDS``, ``get_config`` and one module per
architecture); ``tests/test_torch_models.py`` holds every ``CONFIG`` and
``SMOKE`` equal to the reference's, field by field."""
