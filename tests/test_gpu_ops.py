"""Checks that need the card: the phase-1 comparisons of chip_smoke.py
(the OA-Mix image ops and RoIAlign against their plain references, at
flagship widths). Run with ``python -m pytest -m gpu tests/``."""
import pytest

pytestmark = pytest.mark.gpu


def test_translated_ops_match_references_at_flagship_widths(gpu_device):
    import chip_smoke
    chip_smoke.check_ops()
