"""Contact dispatch and the banded contact solve."""
