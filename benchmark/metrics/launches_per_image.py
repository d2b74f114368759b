"""Operations on the card (kernels, copies, memsets) per image (decoded or
encoded) in the traced stretch."""


def read(t):
    if not t.images:
        return None
    return len(t.ops()) / t.images
