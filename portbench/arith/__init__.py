"""Operations, bytes and peaks: the yardstick's arithmetic, one file per
kind of work, computed from shapes alone."""
