"""Share (%) of the encoded images whose device pack overflowed and went to
the host packer: the program's jt.encode.spill spans over the images of the
traced stretch. 0 where images were finished (a jt.encode.finalize or
jt.encode.spill span each) and none spilled."""

from lib import spans

DONE = ("jt.encode.finalize", "jt.encode.spill")


def read(t):
    done = spans.clipped(t, DONE.__contains__)
    if not t.images or not done:
        return None
    return 100.0 * sum(n == "jt.encode.spill" for n, _, _ in done) / t.images
