"""peak_gib.build: the card's allocated-memory peak (GiB) over the window's
build units, from the allocator's counter reset when the window opened."""

from hfbench.readers import peak_gib as read  # noqa: F401
