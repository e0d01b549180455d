from visual_sgraphs.cli import main

raise SystemExit(main())
